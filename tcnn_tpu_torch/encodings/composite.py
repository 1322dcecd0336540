"""Composite encoding (port of ``tcnn_tpu.encodings.composite``; reference:
encodings/composite.h): nested encodings applied to slices of the input.

Nested encodings take explicit ``n_dims_to_encode`` / ``dims_to_encode_begin``
slices; one nested encoding may leave ``n_dims_to_encode`` unspecified and
takes the remaining dims. Outputs are combined by Concatenation (with the
alignment of each nested output propagated to the next, composite.h:188-211),
Sum or Product. The parameters are the nested encodings' in nested order,
so the flat layout and the PCG32 initialisation are the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..common import ReductionType, json_value, lcm_list, next_multiple, string_to_reduction_type
from .base import Encoding, ignore_tpu_arguments


class CompositeEncoding(Encoding):
    """(tcnn_tpu/encodings/composite.py:21-203)"""

    otype = "Composite"
    pad_value = 1.0

    def __init__(self, params: dict, n_dims_to_encode: int):
        super().__init__(n_dims_to_encode)
        from . import create_encoding  # late import: the registry imports this module

        nested_cfgs = params.get("nested")
        if not isinstance(nested_cfgs, (list, tuple)):
            raise ValueError("Must provide an array of nested encodings to CompositeEncoding.")
        self.reduction_type = string_to_reduction_type(json_value(params, "reduction", "Concatenation"))

        total_nested = 0
        explicit_begin = False
        for cfg in nested_cfgs:
            total_nested += json_value(cfg, "n_dims_to_encode", 0)
            if "dims_to_encode_begin" in cfg:
                explicit_begin = True
        if not explicit_begin and total_nested > n_dims_to_encode:
            raise ValueError(
                f"CompositeEncoding: nested encodings must not encode more dims {total_nested} than composite "
                f"{n_dims_to_encode}"
            )
        unspecified = None if explicit_begin else n_dims_to_encode - total_nested

        nested: List[Encoding] = []
        self.dims_to_encode_begin: List[int] = []
        offset = 0
        for cfg in nested_cfgs:
            if "n_dims_to_encode" in cfg:
                if "dims_to_encode_begin" in cfg:
                    offset = cfg["dims_to_encode_begin"]
                n_dims = cfg["n_dims_to_encode"]
            else:
                if unspecified is None:
                    raise ValueError(
                        "CompositeEncoding: may only leave 'n_dims_to_encode' unspecified for a single nested "
                        "encoding"
                    )
                n_dims = unspecified
                unspecified = None
            if n_dims > 0:
                nested.append(create_encoding(n_dims, cfg, alignment=1))
                self.dims_to_encode_begin.append(offset)
            offset += n_dims
        self.nested = nn.ModuleList(nested)

        # Alignment propagation (composite.h:188-211).
        if self.reduction_type == ReductionType.Concatenation:
            dims_so_far = 0
            for i in range(len(self.nested) - 1):
                desired = self.nested[i + 1].required_output_alignment()
                required = next_multiple(dims_so_far + self.nested[i].n_output_dims, desired) - dims_so_far
                self.nested[i].set_padded_output_width(required)
                dims_so_far += self.nested[i].padded_output_width
        else:
            alignment = self.required_output_alignment()
            for enc in self.nested:
                enc.set_alignment(alignment)
            widths = {enc.n_output_dims for enc in self.nested}
            if len(widths) > 1:
                raise ValueError(
                    f"CompositeEncoding: Sum/Product reduction requires equal nested output widths, got "
                    f"{sorted(widths)}"
                )
        self.output_dtype = self._output_dtype
        self._sync_output_dims()

    def _sync_output_dims(self):
        if self.reduction_type == ReductionType.Concatenation:
            self.n_output_dims = sum(e.padded_output_width for e in self.nested)
        else:
            self.n_output_dims = self.nested[0].padded_output_width if len(self.nested) else 0
        self.n_to_pad = 0

    def set_padded_output_width(self, padded_output_width: int):
        """Padding flows into the last nested encoding under Concatenation,
        into every nested one under Sum and Product (composite.h:382-392)."""
        if self.reduction_type == ReductionType.Concatenation:
            prev = self.padded_output_width - self.nested[-1].padded_output_width
            if padded_output_width < prev:
                raise ValueError("padded width too small for composite")
            self.nested[-1].set_padded_output_width(padded_output_width - prev)
        else:
            for enc in self.nested:
                enc.set_padded_output_width(padded_output_width)
        self._sync_output_dims()

    def required_output_alignment(self) -> int:
        return lcm_list([e.required_output_alignment() for e in self.nested] or [1])

    @property
    def output_dtype(self):
        return self._output_dtype

    @output_dtype.setter
    def output_dtype(self, dtype):
        self._output_dtype = dtype
        for enc in getattr(self, "nested", []):
            enc.output_dtype = dtype

    @property
    def n_params(self) -> int:
        return sum(e.n_params for e in self.nested)

    def layer_sizes(self):
        sizes = []
        for e in self.nested:
            sizes.extend(e.layer_sizes())
        return sizes

    def initialize_params(self, rng, scale: float = 1.0) -> np.ndarray:
        parts = [e.initialize_params(rng, scale) for e in self.nested]
        return np.concatenate(parts) if parts else np.zeros((0,), np.float32)

    def _combine(self, params, x, plain: bool, table_dtype: Optional[str]) -> torch.Tensor:
        outputs = []
        offset = 0
        for enc, begin in zip(self.nested, self.dims_to_encode_begin):
            p = params[offset: offset + enc.n_params]
            offset += enc.n_params
            xin = x[:, begin: begin + enc.n_dims_to_encode]
            # Only the serve-time table_dtype is forwarded, to the nested
            # encodings that take it (grids), as the JAX package forwards
            # only its prebuilt serving tables (composite.py:167-191).
            kw = {"table_dtype": table_dtype} if table_dtype is not None and hasattr(enc, "served_levels") else {}
            outputs.append(enc.apply_plain(p, xin, **kw) if plain else enc.apply(p, xin, **kw))
        if self.reduction_type == ReductionType.Concatenation:
            y = torch.cat(outputs, dim=1)
        elif self.reduction_type == ReductionType.Sum:
            y = sum(outputs[1:], outputs[0])
        else:
            y = outputs[0]
            for o in outputs[1:]:
                y = y * o
        return y.to(self.output_dtype)

    def apply(self, params: torch.Tensor, x: torch.Tensor, served_tables=None,
              table_dtype: Optional[str] = None) -> torch.Tensor:
        """Encode ``x`` (batch, n_dims_to_encode): the JAX package's
        ``apply(params, x, served_tables=None)`` (tcnn_tpu/encodings/
        composite.py:167), ``served_tables`` accepted and ignored; then
        ``table_dtype``, the serve-time precision ``FrozenServer`` passes,
        forwarded to the nested grids."""
        ignore_tpu_arguments("CompositeEncoding.apply", served_tables=served_tables)
        return self._combine(params, x, False, table_dtype)

    def apply_plain(self, params: torch.Tensor, x: torch.Tensor, served_tables=None,
                    table_dtype: Optional[str] = None) -> torch.Tensor:
        ignore_tpu_arguments("CompositeEncoding.apply_plain", served_tables=served_tables)
        return self._combine(params, x, True, table_dtype)

    def n_nested(self) -> int:
        return len(self.nested)

    def hyperparams(self):
        return {
            "otype": self.otype,
            "reduction": self.reduction_type.value,
            "nested": [e.hyperparams() for e in self.nested],
        }


__all__ = ["CompositeEncoding", "ReductionType"]
