"""tiny-cuda-nn checkpoint interchange: byte-compatible snapshots (port of
``tcnn_tpu.interchange``).

Trainer snapshots in the reference's layout (reference: trainer.h:442-482),
optimizer state in each optimizer's reference format (adam.h:304-325,
sgd.h:134-139, novograd.h:225-231, ema.h:190-194, average.h:151-156,
batched.h:138-144, lookahead.h:150-154, exponential_decay.h:136-141,
composite.h:142-153). The JAX package writes and reads the same bytes.
Shampoo raises, as the reference does (shampoo.h:963-965).

Binary blobs follow nlohmann::json's ``binary_t`` convention (reference:
gpu_memory_json.h:36-71): native ``bin`` values in MessagePack dumps
(``to_msgpack`` / ``from_msgpack``) and ``{"bytes": [...], "subtype": ...}``
objects in text-JSON dumps (``to_json_obj`` / ``from_json_obj``). Both
readers accept both spellings.

Both packages keep one flat fp32 parameter vector in the same layout
(network matrices first, then the encoding's tables), which is what makes
the blobs meaningful across implementations; ``params_from_numpy`` carries
that vector over directly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class Binary(bytes):
    """A byte blob that must serialize as nlohmann ``binary_t``."""

    subtype: Optional[int] = None


def _bin(t) -> Binary:
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return Binary(np.ascontiguousarray(arr).tobytes())


def _f32(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _as_bytes(value) -> bytes:
    """msgpack bin (bytes), nlohmann text-JSON binary objects
    ({"bytes": [...]}), or plain int lists."""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    if isinstance(value, dict) and "bytes" in value:
        return bytes(bytearray(value["bytes"]))
    if isinstance(value, (list, tuple)):
        return bytes(bytearray(value))
    raise TypeError(f"cannot interpret {type(value)} as a binary blob")


def _as_array(value, dtype) -> np.ndarray:
    return np.frombuffer(_as_bytes(value), dtype=dtype).copy()


# -- JSON / MessagePack codecs -------------------------------------------------


def to_json_obj(data: Any) -> Any:
    """Binary leaves as nlohmann text-JSON binary objects."""
    if isinstance(data, Binary):
        return {"bytes": list(data), "subtype": data.subtype}
    if isinstance(data, dict):
        return {k: to_json_obj(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return [to_json_obj(v) for v in data]
    return data


def from_json_obj(data: Any) -> Any:
    if isinstance(data, dict):
        if set(data) <= {"bytes", "subtype"} and "bytes" in data:
            return Binary(bytearray(data["bytes"]))
        return {k: from_json_obj(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_json_obj(v) for v in data]
    return data


def to_msgpack(data: Any) -> bytes:
    import msgpack

    return msgpack.packb(data, use_bin_type=True)


def from_msgpack(blob: bytes) -> Any:
    import msgpack

    def conv(v):
        if isinstance(v, (bytes, bytearray)):
            return Binary(v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    return conv(msgpack.unpackb(blob, raw=False, strict_map_key=False))


# -- optimizer state <-> reference layout ----------------------------------------


def serialize_optimizer(opt, state) -> Dict:
    """An optimizer's state tree -> the reference's serialize() layout."""
    otype = opt.otype
    if otype == "Adam":
        return {
            "current_step": int(state["step"]),
            "base_learning_rate": float(opt.base_learning_rate),
            "first_moments_binary": _bin(_f32(state["first_moments"])),
            "second_moments_binary": _bin(_f32(state["second_moments"])),
            # (reference: adam.h param_steps are uint32)
            "param_steps_binary": _bin(state["param_steps"].detach().cpu().numpy().astype(np.int32).view(np.uint32)),
        }
    if otype == "SGD":
        return {"current_step": int(state["step"]), "learning_rate": float(opt.base_learning_rate)}
    if otype == "Novograd":
        return {
            "current_step": int(state["step"]),
            "base_learning_rate": float(opt.base_learning_rate),
            "first_moments_binary": _bin(_f32(state["first_moments"])),
            "per_layer_second_moments_binary": _bin(_f32(state["per_layer_second_moments"])),
        }
    if otype == "EMA":
        return {
            "nested": serialize_optimizer(opt.nested(), state["nested"]),
            "weights_ema_binary": _bin(_f32(state["weights_ema"])),
        }
    if otype == "Average":
        return {
            "nested": serialize_optimizer(opt.nested(), state["nested"]),
            "weights_samples_binary": _bin(_f32(state["weights_samples"])),
            "weights_average_binary": _bin(_f32(state["weights_average"])),
        }
    if otype == "Batched":
        avg = _f32(state["averaged_gradients"])
        return {
            "nested": serialize_optimizer(opt.nested(), state["nested"]),
            "averaged_gradients_binary": _bin(avg),
            # The reference keeps a half-precision copy for its compute path
            # (batched.h); a cast of it, as the JAX package writes.
            "averaged_gradients_half_binary": _bin(avg.astype(np.float16)),
            "current_step": int(state["step"]),
        }
    if otype == "Lookahead":
        return {
            "nested": serialize_optimizer(opt.nested(), state["nested"]),
            "weights_lookahead_binary": _bin(_f32(state["weights_lookahead"])),
        }
    if otype == "ExponentialDecay":
        return {
            "nested": serialize_optimizer(opt.nested(), state["nested"]),
            "learning_rate": float(opt.learning_rate),
            "learning_rate_factor": float(state["lr_factor"]),
        }
    if otype == "Composite":
        return {
            "nested": [serialize_optimizer(o, s) for o, s in zip(opt._nested, state["nested"])],
            "base_learning_rates": [float(o.learning_rate) for o in opt._nested],
            "learning_rate_factor": 1.0,
        }
    if otype == "Shampoo":
        # (reference: shampoo.h:963-965)
        raise NotImplementedError("The Shampoo optimizer does not yet support serialization.")
    raise NotImplementedError(f"no reference serialization for {otype}")


def deserialize_optimizer(opt, state, data: Dict):
    """A reference-layout optimizer blob -> a new state tree shaped like
    ``state`` (which gives shapes, dtypes and the device)."""
    otype = opt.otype

    def vec(key, like, dtype=np.float32):
        arr = _as_array(data[key], dtype)
        if arr.size != like.numel():
            raise ValueError(f"{otype}.{key}: checkpoint has {arr.size} entries, state needs {like.numel()}")
        return torch.from_numpy(arr.reshape(tuple(like.shape))).to(device=like.device, dtype=like.dtype)

    def scalar(value, like):
        return torch.full((), value, dtype=like.dtype, device=like.device)

    def nested():
        return deserialize_optimizer(opt.nested(), state["nested"], data["nested"])

    if otype == "Adam":
        new = dict(state)
        new["step"] = scalar(int(data["current_step"]), state["step"])
        new["first_moments"] = vec("first_moments_binary", state["first_moments"])
        new["second_moments"] = vec("second_moments_binary", state["second_moments"])
        if "param_steps_binary" in data:  # uint32 counts, read as the int32 state's bits
            new["param_steps"] = vec("param_steps_binary", state["param_steps"], np.int32)
        else:  # (reference: adam.h deserialize zero-fills when absent)
            new["param_steps"] = torch.zeros_like(state["param_steps"])
        opt.base_learning_rate = float(data["base_learning_rate"])
        return new
    if otype == "SGD":
        opt.base_learning_rate = float(data["learning_rate"])
        return {"step": scalar(int(data["current_step"]), state["step"])}
    if otype == "Novograd":
        new = dict(state)
        new["step"] = scalar(int(data["current_step"]), state["step"])
        new["first_moments"] = vec("first_moments_binary", state["first_moments"])
        new["per_layer_second_moments"] = vec("per_layer_second_moments_binary", state["per_layer_second_moments"])
        opt.base_learning_rate = float(data["base_learning_rate"])
        return new
    if otype == "EMA":
        blob = _as_bytes(data["weights_ema_binary"])
        like = state["weights_ema"]
        # The reference's EMA stores fp16 or fp32 weights by its template
        # type (ema.h:45-75); the byte length tells which.
        dtype = np.float16 if len(blob) == 2 * like.numel() else np.float32
        ema = np.frombuffer(blob, dtype).astype(np.float32)
        return {"nested": nested(), "weights_ema": torch.from_numpy(ema).to(like.device)}
    if otype == "Average":
        return {
            "nested": nested(),
            "weights_samples": vec("weights_samples_binary", state["weights_samples"]),
            "weights_average": vec("weights_average_binary", state["weights_average"]),
        }
    if otype == "Batched":
        return {
            "nested": nested(),
            "step": scalar(int(data["current_step"]), state["step"]),
            "averaged_gradients": vec("averaged_gradients_binary", state["averaged_gradients"]),
        }
    if otype == "Lookahead":
        return {"nested": nested(), "weights_lookahead": vec("weights_lookahead_binary", state["weights_lookahead"])}
    if otype == "ExponentialDecay":
        opt.learning_rate = float(data["learning_rate"])
        return {"nested": nested(), "lr_factor": scalar(float(data["learning_rate_factor"]), state["lr_factor"])}
    if otype == "Composite":
        for o, lr in zip(opt._nested, data.get("base_learning_rates") or []):
            o.learning_rate = float(lr)
        return {
            "nested": [deserialize_optimizer(o, s, d) for o, s, d in zip(opt._nested, state["nested"], data["nested"])]
        }
    if otype == "Shampoo":
        raise NotImplementedError("The Shampoo optimizer does not yet support deserialization.")
    raise NotImplementedError(f"no reference deserialization for {otype}")


# -- trainer snapshots -----------------------------------------------------------


def serialize_trainer(trainer, serialize_optimizer_state: bool = False) -> Dict:
    """Reference-layout snapshot (reference: trainer.h:442-455). Like the
    reference, the params blob holds the INFERENCE params (the EMA, average
    or lookahead weights where the optimizer keeps them)."""
    data = {
        "n_params": int(trainer.n_params),
        "params_type": "float",
        "params_binary": _bin(_f32(trainer.inference_params())),
    }
    if serialize_optimizer_state:
        data["optimizer"] = serialize_optimizer(trainer.optimizer, trainer.opt_state)
    return data


def deserialize_trainer(trainer, data: Dict) -> None:
    """(reference: trainer.h:457-482). Accepts float and __half params."""
    ptype = data.get("params_type", "float")
    if ptype == "float":
        params = _as_array(data["params_binary"], np.float32)
    elif ptype in ("__half", "half"):
        params = _as_array(data["params_binary"], np.float16).astype(np.float32)
    else:
        raise ValueError("Trainer: snapshot parameters must be of type float or __half")
    n = int(data.get("n_params", params.size))
    if n != trainer.n_params or params.size != trainer.n_params:
        raise ValueError(f"checkpoint has {n} params ({params.size} in blob), model has {trainer.n_params}")
    enc = getattr(trainer.model, "encoding", None)
    if getattr(enc, "hash_auto_resolved", False):
        from .utils.log import log_warning

        log_warning(
            "deserialize: this model's grid hash was auto-selected "
            "(CoherentAdditive). If the checkpoint was trained by the "
            "reference under ITS default hash, rebuild the model with "
            "\"hash\": \"CoherentPrime\" — otherwise the hashed levels "
            "index differently and outputs will be garbage."
        )
    trainer.params = torch.from_numpy(params)
    if "optimizer" in data:
        trainer.opt_state = deserialize_optimizer(trainer.optimizer, trainer.opt_state, data["optimizer"])


def params_from_numpy(flat, model) -> torch.Tensor:
    """The JAX package's flat parameters (a numpy array, e.g. from
    ``trainer.params``, ``trainer.inference_params()`` or a
    ``tcnn_tpu.modules`` module's ``params``) as a float32 tensor on
    ``model``'s device, ready for ``trainer.params = ...`` or a module's
    ``params.copy_(...)``. ``model`` is anything with ``n_params`` and
    ``params``: a ``NetworkWithInputEncoding`` or a ``modules`` module."""
    arr = np.asarray(flat)
    if arr.dtype != np.float32:
        raise ValueError(f"params_from_numpy: expected float32 params, got {arr.dtype}")
    if arr.shape != (model.n_params,):
        raise ValueError(f"params_from_numpy: got shape {arr.shape}, model has {model.n_params} params")
    return torch.from_numpy(np.array(arr, copy=True)).to(model.params.device)
