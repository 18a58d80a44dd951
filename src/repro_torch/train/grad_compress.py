"""Int8 error-feedback gradient compression for the cross-pod all-reduce,
the counterpart of :mod:`repro.train.grad_compress`.

Within a pod gradients reduce over the fast links; across pods they cross
the slow one. This module compresses exactly that hop: per-pod-reduced
gradients are quantized to int8 with a per-tensor scale, summed over the
``pod`` axis in int32 and dequantized, a ~4x saving on the wire. The
quantization error is carried in an error-feedback accumulator (EF-SGD),
so the bias vanishes over steps instead of accumulating.

The JAX package runs it under ``shard_map``, each leaf under its
partition spec over the non-pod axes, so each device works on its block.
The port's ranks hold their blocks already: each leaf of ``grads`` is
this rank's block, and the scale is that block's, as in the JAX package.
The scales of all leaves cross in one all-reduce (MAX) and the codes of
all leaves in another (int32 SUM); both are exact, so each leaf's result
is the JAX package's per-leaf ``pmax`` and ``psum``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.parallel import collectives
from repro_torch.parallel.axisinfo import AxisInfo
from repro_torch.train.optimizer import _tree_map, leaves
from repro_torch.train.trainer import _unflatten


def ef_init(grads) -> Any:
    """f32 zeros shaped like each leaf of ``grads``, on its device."""
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_pod_mean(grads, err_state, axis_info: AxisInfo, specs_tree=None, pod_axis: str = "pod"):
    """Mean-reduce ``grads`` over the pod axis with int8 EF compression.

    ``grads`` must already be identical within each pod (the data-parallel
    reduction guarantees this); each leaf is this rank's block
    (``specs_tree``, each leaf's spec over the non-pod axes, is taken for
    the JAX package's signature: the blocks need no resharding). Returns
    (grads_mean, new_err_state); without a pod axis, the inputs as they
    are. Per leaf: ``gf = g + err`` in f32, ``scale = max(|gf|, 1e-12) /
    127`` and its maximum over the pods, ``q = clip(round(gf / scale),
    -127, 127)`` as int8, the residual ``gf - q * scale`` (rounded once), and the mean
    ``sum(q) * scale / n`` over the ``n`` pods, in the leaf's dtype: the
    JAX package's numbers, bit for bit, on the CPU."""
    mesh = axis_info.mesh
    if pod_axis not in mesh.axis_names:
        return grads, err_state  # single-pod: nothing to do

    flat_g, flat_e = leaves(grads), leaves(err_state)
    dev = flat_g[0].device
    # the JAX package's "/ 127.0" compiles to a product with the f32 reciprocal of 127
    # (XLA folds a division by a constant so), hence the product here; ``n`` is a tensor
    # divisor, as CUDA divides by a Python scalar as a product with its reciprocal
    inv127 = torch.full((), 1 / 127, dtype=torch.float32, device=dev)
    n = torch.full((), collectives.axis_size(pod_axis, mesh), dtype=torch.float32, device=dev)
    gf = [g.float() + e for g, e in zip(flat_g, flat_e)]
    scales = torch.stack([torch.clamp_min(torch.max(torch.abs(x)), 1e-12) * inv127 for x in gf])
    scales = collectives.pmax(scales, pod_axis, mesh)  # sync scales (one scalar a leaf)
    q = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int8) for x, s in zip(gf, scales)]
    # the residual rounded once, as XLA computes it (a fused multiply-add): q * scale is
    # exact in f64, and so is its difference from gf, which lies within a step of it
    new_err = [(x.double() - qq.double() * s.double()).float() for x, qq, s in zip(gf, q, scales)]
    q_sum = collectives.psum(torch.cat([qq.reshape(-1).to(torch.int32) for qq in q]), pod_axis, mesh)
    out, k = [], 0
    for g, s in zip(flat_g, scales):
        part = q_sum[k:k + g.numel()].view(g.shape)
        out.append((part.float() * s / n).to(g.dtype))
        k += g.numel()
    return _unflatten(grads, out), _unflatten(grads, new_err)
