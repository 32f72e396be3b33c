"""Operations and bytes of a cell's work, and the chip's peaks.

A configuration's reference counts its model's operations
(``serve_flops``, ``train_flops``) by running itself on the ``meta``
device under ``torch.utils.flop_counter.FlopCounterMode``, with the
helpers here (a multiply-add counts 2; products only: convolutions,
matrix products and einsums). A train step counts its forward and the
backward of what trains, the same work whatever implements it. The
attention's least time (for the ``attn_roofline`` metrics) counts the
relation modules' and the learned-NMS attention's products and the bytes
they must read and write once: the same modules in every configuration.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_F32 = 67e12          # float32 outside the tensor cores (TF32 off)
PEAK_TF32 = 495e12        # the fastest rate for float32-accurate products
HBM_BYTES_S = 3.35e12


def meta_params(specs, trains=None) -> dict:
    """{name: empty tensor on the ``meta`` device} of a reference's
    ``param_specs`` list; those for which ``trains(name)`` holds require a
    gradient."""
    P = {}
    for name, shape in specs:
        t = torch.empty(shape, device="meta")
        if trains is not None and trains(name):
            t.requires_grad_(True)
        P[name] = t
    return P


def count_flops(fn) -> int:
    """The operations ``fn()`` runs, as FlopCounterMode counts them."""
    with FlopCounterMode(display=False) as mode:
        fn()
    return int(mode.get_total_flops())


def attention_least_s(config, R: int, K: int, first_n: int) -> float:
    """Least time of one image's attention forward: the two relation
    modules over R rows and K keys and the learned-NMS attention over
    ``first_n`` boxes of every class; per module the operations at
    PEAK_TF32 or the bytes of their inputs, weights and outputs (f32, each
    read or written once) at HBM_BYTES_S, whichever is larger."""
    C, G, D, F_ = int(config["arch"]["num_classes"]) - 1, 16, 1024, first_n
    rel_ops = 2 * (R * D * D + K * D * D + R * K * D + R * K * D * G
                   + R * G * D * 64 + R * K * 64 * G)
    rel_bytes = 4 * (2 * R * D + 4 * R * K + 2 * D * D + G * D * 64 + 64 * G)
    nms_ops = 2 * (2 * C * F_ * 128 * D + C * F_ * F_ * D + C * G * F_ * F_ * 128
                   + C * F_ * G * 128 * 8 + C * F_ * F_ * 64 * G)
    nms_bytes = 4 * (2 * C * F_ * 128 + 4 * C * F_ * F_ + 2 * 128 * D
                     + G * 128 * 8 + 64 * G)

    def least(ops, nbytes):
        return max(ops / PEAK_TF32, nbytes / HBM_BYTES_S)
    return 2 * least(rel_ops, rel_bytes) + least(nms_ops, nms_bytes)
