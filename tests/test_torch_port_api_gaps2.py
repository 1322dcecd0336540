"""The port's ``utils`` and ``common`` surface against the JAX package's, on
the CPU.

- ``tcnn_tpu_torch.utils`` re-exports the nine log names with the JAX
  package's ``__all__``, and ``set_log_callback`` routes a ``log_info``
  through the callback in both packages alike.
- ``tcnn_tpu_torch.common`` has the JAX package's ``GradientMode``, ``PI``,
  ``BATCH_SIZE_GRANULARITY``, integer helpers, Morton codes,
  ``equals_case_insensitive``, ``to_string`` and ``check_throw``, each
  case of one parametrised test giving equal results in both packages
  (exact: integers, strings, enum values and uint64 Morton codes bit for
  bit).
"""

import importlib

import numpy as np
import pytest

import tcnn_tpu.common as jc
import tcnn_tpu.utils as ju
import tcnn_tpu_torch.common as tc_
import tcnn_tpu_torch.utils as tu

# The modules themselves: in both packages ``utils.log`` the attribute is the
# re-exported function ``log``, which shadows the submodule.
jlog = importlib.import_module("tcnn_tpu.utils.log")
tlog = importlib.import_module("tcnn_tpu_torch.utils.log")


def test_utils_exports_the_jax_log_names():
    assert set(tu.__all__) == set(ju.__all__)
    for name in ju.__all__:
        assert getattr(tu, name) is getattr(tlog, name), name
    from tcnn_tpu_torch.utils import LogSeverity, log_info, set_verbose  # noqa: F401

    assert [(m.name, int(m)) for m in tu.LogSeverity] == [(m.name, int(m)) for m in ju.LogSeverity]


@pytest.mark.parametrize("emit", ["log_debug", "log_info", "log_success", "log_warning", "log_error"])
def test_log_callback_routes_like_jax(monkeypatch, emit):
    got = {}
    for pkg, mod in (("jax", jlog), ("port", tlog)):
        records = got[pkg] = []
        monkeypatch.setattr(mod, "_callback", None)
        getattr(mod, "set_log_callback")(lambda sev, msg, records=records: records.append((int(sev), sev.name, msg)))
        getattr(mod, emit)("hello 1")
        mod.log(mod.LogSeverity.Info, "hello 2")
        mod.set_log_callback(None)
    assert got["port"] == got["jax"] and len(got["port"]) == 2


def _mortons(m):
    rng = np.random.default_rng(7)
    u21 = rng.integers(0, 2**21, (3, 1000), dtype=np.uint64)
    u32 = rng.integers(0, 2**32, (2, 1000), dtype=np.uint64)
    wide = rng.integers(0, 2**63, (3, 1000), dtype=np.uint64)  # bits above the width are masked
    edges = np.array([0, 1, 2**21 - 1, 2**32 - 1], np.uint64)
    return [m.morton3d(*u21), m.morton3d(*wide), m.morton2d(*u32), m.morton2d(*wide[:2]),
            m.morton3d(edges, edges[::-1], edges), m.morton2d(edges, edges[::-1]), m.morton2d(5, 3)]


CASES = {
    "GradientMode": lambda m: [(g.name, g.value) for g in m.GradientMode],
    "GradientMode parse": lambda m: m.GradientMode("Accumulate").value,
    "PI": lambda m: m.PI,
    "BATCH_SIZE_GRANULARITY": lambda m: m.BATCH_SIZE_GRANULARITY,
    "previous_multiple": lambda m: [m.previous_multiple(v, d) for v in (0, 1, 127, 128, 129, 1000) for d in (1, 16, 128)],
    "is_pot": lambda m: [m.is_pot(v) for v in (-4, 0, 1, 2, 3, 64, 96, 2**31, 2**31 + 1)],
    "next_pot": lambda m: [m.next_pot(v) for v in (1, 2, 3, 5, 64, 65, 1000, 2**20 + 1, 2**31)],
    "powi": lambda m: [m.powi(b, e) for b in (0, 2, 3, 10) for e in (0, 1, 5, 12)],
    "morton": lambda m: [a.tolist() for a in _mortons(m)],
    "morton dtype": lambda m: [str(a.dtype) for a in _mortons(m)],
    "equals_case_insensitive": lambda m: [m.equals_case_insensitive(a, b) for a, b in
                                          (("ReLU", "relu"), ("HashGrid", "HASHGRID"), ("Tanh", "Tan"), ("", ""))],
    "to_string": lambda m: [m.to_string(m.Activation.ReLU), m.to_string(m.HashType.CoherentAdditive),
                            m.to_string(m.GradientMode.Overwrite), m.to_string("Smoothstep"), m.to_string(3)],
    "check_throw": lambda m: [m.check_throw(True, "fine")] + [_raised(m.check_throw, False, "bad")]
    + [_raised(m.check_throw, 0)],
}


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_common_names_match_jax(name):
    assert CASES[name](tc_) == CASES[name](jc)
