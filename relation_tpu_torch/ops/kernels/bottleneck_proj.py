"""One projection bottleneck block (res2a, res3a, res4a of ResNet-101) with
BatchNorm folded into the weights: CUDA kernel and plain version. Port of
relation_tpu/ops/pallas/bottleneck_proj.py::fused_proj_bottleneck; the
kernel is csrc/bottleneck.cu (``proj_bottleneck``).

With the stride s on the 1x1 convs (Caffe's placement):

    xs  = x[::s, ::s]
    y1  = relu(xs @ Wa + b1)
    y2  = relu(sum_t shift_t(y1) @ W3[t] + b2)
    out = relu(xs @ W1 + b1p + y2 @ Wc + b3)

One call is one memset and one launch of the persistent kernel that also
runs the stack; it runs the last line as one product [xs | y2] @ [W1 ; Wc]. The JAX package defines no gradient for it,
so an input that asks for one is refused on every device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from relation_tpu_torch.ops.kernels import _build

launches = 0          # calls of fused_proj_bottleneck that ran the kernel


def proj_bottleneck_reference(x, w1, b1p, wa, b1, w3, b2, wc, b3, *, stride=1):
    """Plain version (relation_tpu/ops/pallas/bottleneck_proj.py::
    proj_bottleneck_reference, step for step): x [H, W, Cin]; w1 [Cin, Cout];
    wa [Cin, Cmid]; w3 [9*Cmid, Cmid] tap-major; wc [Cmid, Cout]; biases
    f32. -> [H/stride, W/stride, Cout] in x.dtype."""
    Hi, Wi, Cin = x.shape
    Cmid = wa.shape[1]
    H, W = Hi // stride, Wi // stride
    dt = x.dtype
    f32 = torch.float32
    xs = x[::stride, ::stride][:H, :W].reshape(-1, Cin).to(f32)
    sc = xs @ w1.to(f32) + b1p.to(f32)
    y1 = torch.relu(xs @ wa.to(f32) + b1.to(f32)).to(dt).reshape(H, W, Cmid)
    y1pad = F.pad(y1, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((H * W, Cmid), dtype=f32, device=x.device)
    for t in range(9):
        dy, dx = t // 3, t % 3
        patch = y1pad[dy:dy + H, dx:dx + W, :].reshape(-1, Cmid)
        acc = acc + patch.to(f32) @ w3[t * Cmid:(t + 1) * Cmid].to(f32)
    y2 = torch.relu(acc + b2.to(f32)).to(dt)
    y3 = y2.to(f32) @ wc.to(f32) + b3.to(f32)
    return torch.relu(sc + y3).to(dt).reshape(H, W, -1)


def _launch(x, w1, b1p, wa, b1, w3, b2, wc, b3, stride):
    Hi, Wi, Cin = x.shape
    Cmid, Cout = wa.shape[1], wc.shape[1]
    want = {"w1": (Cin, Cout), "b1p": (Cout,), "wa": (Cin, Cmid),
            "b1": (Cmid,), "w3": (9 * Cmid, Cmid), "b2": (Cmid,),
            "wc": (Cmid, Cout), "b3": (Cout,)}
    got = dict(w1=w1, b1p=b1p, wa=wa, b1=b1, w3=w3, b2=b2, wc=wc, b3=b3)
    bad = {k: tuple(got[k].shape) for k, s in want.items()
           if tuple(got[k].shape) != s}
    if bad or Cin % 64 or Cmid % 64 or Cout % 64:
        raise ValueError(f"fused_proj_bottleneck: x {tuple(x.shape)}, "
                         f"mismatched {bad}; the kernel needs Cin, Cmid and "
                         "Cout multiples of 64")
    if any(t.dtype != torch.bfloat16 for t in (x, w1, wa, w3, wc)) or any(
            t.dtype != torch.float32 for t in (b1p, b1, b2, b3)):
        raise TypeError("fused_proj_bottleneck: the CUDA kernel takes a bf16 "
                        "map and bf16 weights with f32 biases")
    ins = [t.contiguous() for t in (x, w1, b1p, wa, b1, w3, b2, wc, b3)]
    _build.check_inputs("fused_proj_bottleneck", *ins)
    H, W = Hi // stride, Wi // stride
    out = torch.empty((H, W, Cout), dtype=torch.bfloat16, device=x.device)
    y1 = torch.empty((H * W, Cmid), dtype=torch.bfloat16, device=x.device)
    y2 = torch.empty_like(y1)
    if any(t.data_ptr() % 16 for t in ins + [out]):
        raise ValueError("fused_proj_bottleneck: tensors must be 16-byte aligned")
    fn = _build.load("bottleneck").proj_bottleneck
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(*[_build.ptr(t) for t in ins + [out, y1, y2]], Hi, Wi, Cin, Cmid,
            Cout, stride, _build.stream_ptr(x.device))
    _build.check(rc, "proj_bottleneck")
    return out


def fused_proj_bottleneck(x, w1, b1p, wa, b1, w3, b2, wc, b3, *,
                          stride=1) -> torch.Tensor:
    """x [H, W, Cin] -> [H/stride, W/stride, Cout] (layouts of
    ``proj_bottleneck_reference``). Raises ValueError when the stride does
    not divide H and W, as the JAX kernel does. CUDA tensors launch the
    kernel (bf16 map and weights, f32 biases, channel counts multiples of
    64); CPU tensors take the plain version. Inference only."""
    Hi, Wi, _ = x.shape
    if Hi % stride or Wi % stride:
        raise ValueError(
            f"fused_proj_bottleneck needs stride-divisible spatial dims, got "
            f"{(Hi, Wi)} at stride {stride}: the conv path uses ceil-mode "
            f"output sizes for odd dims, which this kernel does not replicate")
    _build.refuse_grad("fused_proj_bottleneck", x, w1, b1p, wa, b1, w3, b2,
                       wc, b3)
    if x.device.type != "cuda":
        return proj_bottleneck_reference(x, w1, b1p, wa, b1, w3, b2, wc, b3,
                                         stride=stride)
    out = _launch(x, w1, b1p, wa, b1, w3, b2, wc, b3, stride)
    _build.count(globals(), "launches")
    return out
