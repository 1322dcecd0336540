"""Shampoo (port of ``tcnn_tpu.optimizers.shampoo``; reference:
optimizers/shampoo.h). Per weight matrix G (M x N):

- elementwise (all params): debiased Adam-style moments give the grafting
  momentum m1 / (sqrt(m2) + eps) (shampoo.h:166-192);
- per matrix the preconditioners L (M x M) and R (N x N), debiased EMAs of
  G G^T and G^T G of the momentum (``cg_on_momentum``, else of the
  descaled gradient; shampoo.h:721-757);
- update = EMA_{beta_shampoo}(L^{-1/4} G R^{-1/4}), its step scaled so
  that its Frobenius norm is the grafting momentum's
  (``frobenius_normalization``, shampoo.h:798-801), consuming the roots of
  the previous refresh; nothing matrix-shaped moves on the first step;
- the roots refreshed at the end of the step, on the schedule that rotates
  over runs of same-shape matrices (interval 10 before step 100, 200
  after, divided over the runs; shampoo.h:832-842), by the coupled Newton
  iteration for the inverse 4th root (shampoo.h:434-631): one step, then
  steps while the change is above 1e-12, at most 30;
- params outside the weight matrices take the plain grafting update
  (shampoo.h:265-283).

Every schedule choice stays on the device, as the port's other optimizers
keep theirs (``optimizers.base``): the refresh flags are tensors, every
matrix's roots are computed each step and kept or replaced by
``torch.where``, and the Newton iteration runs its 30 steps with each
matrix frozen by ``torch.where`` once its change falls to 1e-12 (or is
not finite), the JAX package's ``lax.while_loop`` condition. So a step
makes no host synchronisation and ``Trainer.training_steps`` can capture
it. Plain torch: the JAX package has no kernel here (its products are XLA
matmuls), so the products are ``torch.matmul`` over each run of
same-shape matrices, in fp32 at ``float32_matmul_precision("highest")``.
Serialization raises, as the reference's does (``interchange``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..common import json_value, resolve_device
from .base import Optimizer

NEWTON_ITERS = 30
NEWTON_TOL = 1e-12


def inverse_4th_root(a: torch.Tensor, max_iters: int = NEWTON_ITERS) -> torch.Tensor:
    """A^{-1/4} of each SPD matrix of the batch ``a`` (K, m, m) by the
    coupled Newton iteration (Higham, MIMS EP 2005.9 §3.2; JAX package
    ``_inverse_4th_root``):

        X_0 = (1/c) I,  M_0 = (1/c^4) A,  c = (rho / sqrt(2))^{1/4},
        T_k = (5 I - M_k) / 4,  X_{k+1} = X_k T_k,  M_{k+1} = T_k^4 M_k,

    rho = ||A^4||_F^{1/4} bounding the spectral radius. One unconditional
    step, then ``max_iters - 1`` more, each matrix frozen once the squared
    change of X is at most 1e-12 or not finite."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a2 = a @ a
    a4 = a2 @ a2
    rho = torch.sum(a4 * a4, dim=(-2, -1), keepdim=True) ** 0.125
    inv_c4 = math.sqrt(2.0) / rho
    x = inv_c4**0.25 * eye
    mk = inv_c4 * a

    def body(x, mk):
        t = (5.0 * eye - mk) * 0.25
        t2 = t @ t
        t4 = t2 @ t2
        x_new = x @ t
        return x_new, t4 @ mk, torch.sum((x_new - x) ** 2, dim=(-2, -1), keepdim=True)

    x, mk, delta = body(x, mk)
    for _ in range(max_iters - 1):
        active = (delta > NEWTON_TOL) & torch.isfinite(delta)
        x_new, m_new, d_new = body(x, mk)
        x = torch.where(active, x_new, x)
        mk = torch.where(active, m_new, mk)
        delta = torch.where(active, d_new, delta)
    return x


class ShampooOptimizer(Optimizer):
    otype = "Shampoo"

    _KEYS = (
        ("beta1", "beta1"),
        ("beta2", "beta2"),
        ("beta3", "beta3"),
        ("beta_shampoo", "beta_shampoo"),
        ("epsilon", "epsilon"),
        ("identity_strength", "identity_strength"),
        ("learning_rate", "base_learning_rate"),
        ("l2_reg", "l2_reg"),
        ("relative_decay", "relative_weight_decay"),
        ("absolute_decay", "absolute_weight_decay"),
        ("cg_on_momentum", "cg_on_momentum"),
        ("frobenius_normalization", "frobenius_normalization"),
    )

    def __init__(self, params: Dict = None):
        super().__init__()
        self.base_learning_rate = 1e-3
        self.beta1 = 0.9
        self.beta2 = 0.99
        self.beta3 = 0.9
        self.beta_shampoo = 0.9
        self.epsilon = 1e-8
        self.identity_strength = 0.01
        self.l2_reg = 1e-5
        self.relative_weight_decay = 0.0
        self.absolute_weight_decay = 0.0
        self.cg_on_momentum = True
        self.frobenius_normalization = True
        self.update_hyperparams(params or {})

    def init_state(self, device=None):
        device = resolve_device(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        def eye(n):
            return torch.eye(n, dtype=torch.float32, device=device)

        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "first_moments": zeros(self.n_weights),
            "second_moments": zeros(self.n_weights),
            "shampoo_momentum": zeros(self.n_matrix_weights),
            "L": [zeros(rows, rows) for rows, _ in self.layer_sizes],
            "R": [zeros(cols, cols) for _, cols in self.layer_sizes],
            "L_root": [eye(rows) for rows, _ in self.layer_sizes],
            "R_root": [eye(cols) for _, cols in self.layer_sizes],
        }

    @staticmethod
    def _debiased_alpha_beta(decay: float, prev_step: torch.Tensor):
        """(shampoo.h:312-322); ``prev_step`` the step count before this one."""
        t = prev_step.to(torch.float32)
        debias = 1.0 - torch.pow(decay, t + 1.0)
        return (1.0 - decay) / debias, decay * (1.0 - torch.pow(decay, t)) / debias

    @property
    def matrix_batches(self) -> List[tuple]:
        """Runs of consecutive same-shape matrices, (start, end) layer
        indices (shampoo.h:371-396): the refresh rotates over these."""
        batches = []
        if self.layer_sizes:
            cur, start = self.layer_sizes[0], 0
            for i, p in enumerate(self.layer_sizes):
                if p != cur:
                    batches.append((start, i))
                    start, cur = i, p
            batches.append((start, len(self.layer_sizes)))
        return batches

    def _roots(self, mats: List[torch.Tensor]) -> List[torch.Tensor]:
        """The inverse 4th roots of the symmetrised, identity-blended
        ``mats``, same-shape matrices batched into one Newton iteration."""
        out = [None] * len(mats)
        by_shape: Dict[int, List[int]] = {}
        for i, m in enumerate(mats):
            by_shape.setdefault(m.shape[0], []).append(i)
        s = self.identity_strength
        for n, idx in by_shape.items():
            a = torch.stack([mats[i] for i in idx])
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            a = 0.5 * (a + a.transpose(-1, -2)) * (1 - s) + s * eye
            for i, root in zip(idx, inverse_4th_root(a).unbind(0)):
                out[i] = root
        return out

    def step(self, state, params, grads, loss_scale: float, plain: bool = False):
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return self._step(state, params, grads, loss_scale)
        finally:
            torch.set_float32_matmul_precision(precision)

    def _step(self, state, params, grads, loss_scale: float):
        prev = state["step"]
        current = prev + 1
        first_step = prev == 0
        a1, b1 = self._debiased_alpha_beta(self.beta1, prev)
        a2, b2 = self._debiased_alpha_beta(self.beta2, prev)
        a3, b3 = self._debiased_alpha_beta(self.beta3, prev)
        a_sh, b_sh = self._debiased_alpha_beta(self.beta_shampoo, prev)

        w = params.to(torch.float32)
        raw_g = grads.to(torch.float32) / loss_scale
        g = raw_g + self.l2_reg * w
        first = b1 * state["first_moments"] + a1 * g
        second = b2 * state["second_moments"] + a2 * g * g
        momentum = first / (torch.sqrt(second) + self.epsilon)
        precond_src = momentum if self.cg_on_momentum else raw_g

        # Root refresh schedule (shampoo.h:832-842): every run on the first
        # step, else run (step / interval) mod n_runs where step % interval
        # == 0; the interval is 10 (200 from step 100 on) over the runs,
        # at least 1.
        batches = self.matrix_batches
        n_batches = max(len(batches), 1)
        interval = torch.where(current < 100, max(1, 10 // n_batches), max(1, 200 // n_batches))
        refresh = []
        for bi, (start, end) in enumerate(batches):
            flag = first_step | ((current % interval == 0) & ((current // interval) % n_batches == bi))
            refresh += [flag] * (end - start)

        new_L, new_R, new_sh, new_w = [], [], [], []
        offset = 0
        for li, (rows, cols) in enumerate(self.layer_sizes):
            size = rows * cols
            gm = momentum[offset : offset + size].reshape(rows, cols)
            pm = precond_src[offset : offset + size].reshape(rows, cols)
            new_L.append(b3 * state["L"][li] + a3 * (pm @ pm.T))
            new_R.append(b3 * state["R"][li] + a3 * (pm.T @ pm))
            # The update reads the previous refresh's roots (the reference
            # refreshes at the end of the step, shampoo.h:766-830, 844-856).
            update = state["L_root"][li] @ gm @ state["R_root"][li]
            sh_prev = state["shampoo_momentum"][offset : offset + size].reshape(rows, cols)
            sh = torch.where(first_step, sh_prev, b_sh * sh_prev + a_sh * update)
            new_sh.append(sh.reshape(-1))
            lr = self.base_learning_rate
            if self.frobenius_normalization:
                lr = lr * torch.sqrt(torch.sum(gm * gm)) / torch.sqrt(torch.sum(sh * sh) + 1e-30)
            wm = w[offset : offset + size].reshape(rows, cols)
            decayed = (1 - self.relative_weight_decay * lr) * wm - torch.sign(wm) * (self.absolute_weight_decay * lr)
            new_w.append(torch.where(first_step, wm, decayed - lr * sh).reshape(-1))
            offset += size

        roots = self._roots(new_L + new_R)
        n_layers = len(self.layer_sizes)
        new_Lr = [torch.where(refresh[i], roots[i], state["L_root"][i]) for i in range(n_layers)]
        new_Rr = [torch.where(refresh[i], roots[n_layers + i], state["R_root"][i]) for i in range(n_layers)]

        # The other params: the grafting update (shampoo.h:265-283).
        n_mat = self.n_matrix_weights
        if n_mat < self.n_weights:
            lr = self.base_learning_rate
            wr = w[n_mat:]
            decayed = (1 - self.relative_weight_decay * lr) * wr - torch.sign(wr) * (self.absolute_weight_decay * lr)
            new_w.append(decayed - lr * momentum[n_mat:])

        new_state = {
            "step": current,
            "first_moments": first,
            "second_moments": second,
            "shampoo_momentum": torch.cat(new_sh) if new_sh else state["shampoo_momentum"],
            "L": new_L,
            "R": new_R,
            "L_root": new_Lr,
            "R_root": new_Rr,
        }
        return new_state, torch.cat(new_w) if new_w else w

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        self.base_learning_rate = float(value)

    def update_hyperparams(self, params: Dict):
        for key, attr in self._KEYS:
            v = json_value(params, key, None)
            if v is not None:
                setattr(self, attr, v)

    def hyperparams(self) -> Dict:
        return {"otype": self.otype, **{key: getattr(self, attr) for key, attr in self._KEYS}}
