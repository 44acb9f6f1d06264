"""DNN convolutions (forward + backward).

Reference: /root/reference/src/dnn.c — Caffe/darknet-derived im2col/col2im +
OpenMP naive gemm (dnn.c:16-193), NCHW Conv2D forward/backward
(dnn.c:196-368), Conv1D with groups/dilation/4 padding modes (dnn.c:371-464),
and a cuDNN descriptor path (cuda/cuda_dnn.cu:21-280).

Design: `lax.conv_general_dilated` IS the im2col+gemm — XLA lowers it to
the backend's convolution (cuDNN on a GPU) with fused layout handling, and
`lax.conv_transpose`-style dilated convs give the backward passes. Gradients
are also available through jax.vjp on conv2d_forward; the explicit backward
entry points mirror the reference API.
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

from numpower_tpu.ops.creation import asarray

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


_DN_2D = ("NCHW", "OIHW", "NCHW")


def conv2d_forward(x, w, bias=None, stride: IntPair = 1, padding="SAME",
                   dilation: IntPair = 1) -> jax.Array:
    """NDArray_Conv2D_Forward (dnn.c:196-310): x NCHW, w OIHW.

    The reference hardcodes stride-1 'same' im2col; stride/padding/dilation
    are generalized here.
    """
    x, w = asarray(x), asarray(w)
    if isinstance(padding, int):
        p = _pair(padding)
        padding = [(p[0], p[0]), (p[1], p[1])]
    out = lax.conv_general_dilated(
        x, w,
        window_strides=_pair(stride),
        padding=padding,
        rhs_dilation=_pair(dilation),
        dimension_numbers=_DN_2D,
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    if bias is not None:
        out = out + asarray(bias).reshape(1, -1, 1, 1)
    return out


def conv2d_backward(x, w, grad_out, stride: IntPair = 1, padding="SAME",
                    dilation: IntPair = 1) -> Tuple[jax.Array, jax.Array]:
    """NDArray_Conv2D_Backward (dnn.c:234-368): returns (dInput, dW).

    Implemented as the exact vjp of conv2d_forward — XLA emits the
    transposed-conv (data grad) and the cross-correlation (filter grad) as
    convolutions, the equivalent of col2im + gemm_nt.
    """
    x, w, grad_out = asarray(x), asarray(w), asarray(grad_out)
    _, vjp = jax.vjp(
        lambda xx, ww: conv2d_forward(xx, ww, None, stride, padding, dilation), x, w
    )
    dx, dw = vjp(grad_out)
    return dx, dw


_PAD_MODES_1D = {"same": "SAME", "valid": "VALID", "full": None, "causal": None}


def conv1d_forward(x, w, stride: int = 1, padding: str = "same",
                   dilation: int = 1, groups: int = 1) -> jax.Array:
    """NDArray_Conv1D (dnn.c:371-464): x (N, C_in, L), w (C_out, C_in/groups, K);
    groups / dilation / padding modes same|valid|full|causal."""
    x, w = asarray(x), asarray(w)
    k = w.shape[-1]
    eff_k = (k - 1) * dilation + 1
    mode = padding.lower()
    if mode == "same":
        pad = [((eff_k - 1) // 2, eff_k - 1 - (eff_k - 1) // 2)]
    elif mode == "valid":
        pad = [(0, 0)]
    elif mode == "full":
        pad = [(eff_k - 1, eff_k - 1)]
    elif mode == "causal":
        pad = [(eff_k - 1, 0)]
    else:
        raise ValueError(f"unknown padding mode {padding!r}")
    return lax.conv_general_dilated(
        x, w,
        window_strides=(stride,),
        padding=pad,
        rhs_dilation=(dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        feature_group_count=groups,
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
