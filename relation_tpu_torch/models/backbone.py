"""ResNet-101 C4 trunk and dilated C5, plain or deformable, with frozen
BatchNorm (port of relation_tpu/models/backbone.py; reference
rcnn_base.py:29-683, resnet_v1_101_rcnn_dcn.py:688-755).

NCHW inside. Module names mirror the flax tree of the JAX package
(``Bottleneck_<i>`` auto-scopes, Caffe-style conv/bn names), so the flax
'/'-joined parameter paths map onto these modules one to one
(relation_tpu_torch/convert.py). Convs compute in ``dtype`` (bf16 on the
card by default); BatchNorm folds to a per-channel f32 affine cast to the
activation dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relation_tpu_torch.ops.deform import deformable_conv_batched
from relation_tpu_torch.ops.kernels.stem import stem_conv1_bn_relu


class FrozenBatchNorm(nn.Module):
    """use_global_stats BatchNorm with frozen affine: a constant per-channel
    scale/shift. The four vectors are buffers (never trained here)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("gamma", torch.ones(channels))
        self.register_buffer("beta", torch.zeros(channels))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_var", torch.ones(channels))
        self._cache = None

    def folded(self):
        """(scale, bias) in f32."""
        scale = self.gamma / torch.sqrt(self.moving_var + self.eps)
        return scale, self.beta - self.moving_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW (channel axis 1). The folded vectors are cached per dtype,
        device and inference mode (a vector made under inference_mode cannot
        enter autograd), and rebuilt when a buffer changes (load_state_dict
        bumps _version): one elementwise launch per call instead of eight."""
        key = (x.dtype, x.device, torch.is_inference_mode_enabled()) + tuple(
            b._version for b in (self.gamma, self.beta, self.moving_mean,
                                 self.moving_var))
        if self._cache is None or self._cache[0] != key:
            scale, bias = self.folded()
            shape = (1, -1) + (1,) * (x.dim() - 2)
            self._cache = (key, scale.to(x.dtype).view(shape),
                           bias.to(x.dtype).view(shape))
        _, scale, bias = self._cache
        return torch.addcmul(bias, x, scale)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with f32 master weights that computes in ``compute_dtype``
    (the flax ``dtype=`` / ``param_dtype=float32`` policy): the input and the
    parameters are cast at the call. None computes in the weight's dtype.

    A weight that needs no gradient (inference, a frozen stage) is cast once
    and the copy is kept, keyed like FrozenBatchNorm's fold on the
    parameter's version, so a request pays no cast; a weight being trained
    is cast at every call, with the gradient flowing through the cast to the
    f32 master."""

    compute_dtype: torch.dtype | None = None

    def _cast(self, p: torch.Tensor, dt: torch.dtype, slot: str):
        if p is None or p.dtype == dt:
            return p
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(dt)
        key = (dt, p.device, p.data_ptr(), p._version,
               torch.is_inference_mode_enabled())
        cache = self.__dict__.setdefault("_cast_cache", {})
        hit = cache.get(slot)
        if hit is None or hit[0] != key:
            hit = cache[slot] = (key, p.detach().to(dt))
        return hit[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self._cast(self.weight, dt, "w"),
                                  self._cast(self.bias, dt, "b"))


def _conv(cin, cout, kernel, stride=1, dilation=1, bias=False):
    pad = ((kernel - 1) // 2) * dilation
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: 1x1 (stride) -> 3x3 (dilation) -> 1x1, with an
    optional branch1 projection."""

    def __init__(self, prefix: str, cin: int, mid: int, out: int,
                 stride: int = 1, dilation: int = 1, has_proj: bool = False):
        super().__init__()
        p = prefix
        self.has_proj = has_proj
        if has_proj:
            setattr(self, f"res{p}_branch1", _conv(cin, out, 1, stride))
            setattr(self, f"bn{p}_branch1", FrozenBatchNorm(out))
        setattr(self, f"res{p}_branch2a", _conv(cin, mid, 1, stride))
        setattr(self, f"bn{p}_branch2a", FrozenBatchNorm(mid))
        setattr(self, f"res{p}_branch2b", _conv(mid, mid, 3, 1, dilation))
        setattr(self, f"bn{p}_branch2b", FrozenBatchNorm(mid))
        setattr(self, f"res{p}_branch2c", _conv(mid, out, 1))
        setattr(self, f"bn{p}_branch2c", FrozenBatchNorm(out))
        self._names = [f"res{p}_branch1", f"bn{p}_branch1"] + [
            f"{k}{p}_branch2{s}" for s in "abc" for k in ("res", "bn")]

    def forward(self, x):
        m = [getattr(self, n, None) for n in self._names]
        sc = m[1](m[0](x)) if self.has_proj else x
        y = F.relu(m[3](m[2](x)))
        y = F.relu(m[5](m[4](y)))
        y = m[7](m[6](y))
        return F.relu(sc + y)


class _Conv1Weights(nn.Module):
    """Holds the [64, 3, 7, 7] conv1 weight (flax path conv1/kernel)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))


def conv1_w4(w7: torch.Tensor) -> torch.Tensor:
    """Re-index the OIHW [64, C, 7, 7] conv1 weight for the s2d stem:
    -> [16*4C, 64], rows ((di*4 + dj)*4C + (pi*2 + pj)*C + c), as
    relation_tpu/models/backbone.py::conv1_w4 lays out its HWIO input."""
    C = w7.shape[1]
    w8 = F.pad(w7.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))  # [8,8,C,64]
    return (w8.reshape(4, 2, 4, 2, C, 64).permute(0, 2, 1, 3, 4, 5)
            .reshape(16 * 4 * C, 64))


def image_to_s2d_planar(img_hwc):
    """[H, W, C] -> [4C, H/2, W/2], channel order (pi, pj, c). numpy or torch."""
    H, W, C = img_hwc.shape
    x = img_hwc.reshape(H // 2, 2, W // 2, 2, C)
    x = x.permute(1, 3, 4, 0, 2) if isinstance(x, torch.Tensor) \
        else x.transpose(1, 3, 4, 0, 2)
    return x.reshape(4 * C, H // 2, W // 2)


def _unit_names(stage: int, n: int):
    if stage in (2, 5):
        return [f"{stage}{s}" for s in "abc"[:n]]
    return [f"{stage}a"] + [f"{stage}b{i}" for i in range(1, n)]


_PLAN = {2: (3, 64, 256, 1), 3: (4, 128, 512, 2), 4: (23, 256, 1024, 2)}


class ResNet101C4(nn.Module):
    """conv1 .. res4b22, stride 16. Input: s2d planar [B, 12, H/2, W/2] or
    NHWC [B, H, W, 3]; output NCHW [B, 1024, H/16, W/16] in ``dtype``.

    The s2d stem of a bf16 trunk is the fused stem kernel
    (ops/kernels/stem.py), any shape; an f32 trunk runs the same tap matmul
    in f32. res4_folded / trunk_folded (TPU-only fused Pallas stacks) are
    not ported."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 freeze_through: int = 0):
        super().__init__()
        self.dtype = dtype
        # no gradient below the end of this stage (0 = none; 2, 3 or 4): the
        # stem and the stages up to it run under no_grad, the counterpart of
        # the JAX package's stop_gradient boundary. The parameters there are
        # frozen by the trainer, so no gradient is lost, and none of their
        # activations is kept for a backward.
        self.freeze_through = freeze_through
        self.conv1 = _Conv1Weights()
        self.bn_conv1 = FrozenBatchNorm(64)
        i, cin = 0, 64
        for stage, (n, mid, out, stride) in _PLAN.items():
            for u, name in enumerate(_unit_names(stage, n)):
                setattr(self, f"Bottleneck_{i}", Bottleneck(
                    name, cin, mid, out, stride if u == 0 else 1,
                    has_proj=(u == 0)))
                i, cin = i + 1, out
        self.n_units = i

    def _frozen_units(self) -> int:
        """Units of the stages 2..freeze_through."""
        return sum(n for stage, (n, _, _, _) in _PLAN.items()
                   if stage <= self.freeze_through)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        w7 = self.conv1.weight
        if x.dim() == 4 and x.shape[1] == 12:
            B, K, Ho, Wo = x.shape
            w4 = conv1_w4(w7.float())
            if self.dtype == torch.bfloat16:
                scale, bias = self.bn_conv1.folded()
                out = stem_conv1_bn_relu(x.float(), w4, scale, bias)
            else:
                sp = F.pad(x.to(self.dtype), (2, 1, 2, 1))
                taps = torch.cat([sp[:, :, dh:dh + Ho, dw:dw + Wo]
                                  for dh in range(4) for dw in range(4)], dim=1)
                out = torch.einsum("ko,bkn->bon", w4.to(self.dtype),
                                   taps.reshape(B, 16 * K, Ho * Wo))
                out = F.relu(self.bn_conv1(out.reshape(B, 64, Ho, Wo)))
            out = out.to(self.dtype)
        else:
            xc = x.permute(0, 3, 1, 2).to(self.dtype)
            out = F.conv2d(xc, w7.to(self.dtype), stride=2, padding=3)
            out = F.relu(self.bn_conv1(out))
        # MXNet pool1: 3x3/2, pad 1 (padding never wins the max)
        return F.max_pool2d(out, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frozen = self._frozen_units()
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.freeze_through < 2):
            x = self.stem(x)
            for i in range(frozen):
                x = getattr(self, f"Bottleneck_{i}")(x)
        for i in range(frozen, self.n_units):
            x = getattr(self, f"Bottleneck_{i}")(x)
        return x


class ResNet101C5(nn.Module):
    """res5a..res5c: stride 1, 3x3 convs dilated 2 (rcnn_base.py:621-683)."""

    def __init__(self):
        super().__init__()
        cin = 1024
        for i, name in enumerate(_unit_names(5, 3)):
            setattr(self, f"Bottleneck_{i}", Bottleneck(
                name, cin, 512, 2048, 1, dilation=2, has_proj=(i == 0)))
            cin = 2048

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"Bottleneck_{i}")(x)
        return x


class DCNBottleneck(nn.Module):
    """Bottleneck whose 3x3 is a deformable convolution steered by a learned
    offset field (port of relation_tpu/models/backbone.py::DCNBottleneck).

    ``res<p>_branch2b_offset`` is an f32 3x3 conv (dilated, with bias, 2 * 9
    channels per deformable group, zero at initialisation) and
    ``res<p>_branch2b_weight`` the deformable conv's bare weight, stored
    OIHW like every conv weight here (the flax leaf is HWIO). Input and
    output are NCHW; the deformable op itself runs NHWC."""

    def __init__(self, prefix: str, cin: int, mid: int, out: int,
                 dilation: int = 2, deform_groups: int = 4,
                 has_proj: bool = False):
        super().__init__()
        p = prefix
        self.prefix, self.has_proj = p, has_proj
        self.dilation, self.deform_groups = dilation, deform_groups
        if has_proj:
            setattr(self, f"res{p}_branch1", _conv(cin, out, 1))
            setattr(self, f"bn{p}_branch1", FrozenBatchNorm(out))
        setattr(self, f"res{p}_branch2a", _conv(cin, mid, 1))
        setattr(self, f"bn{p}_branch2a", FrozenBatchNorm(mid))
        # always f32 (compute_dtype stays None): build_model sets the trunk's
        # dtype on Conv2d instances only
        setattr(self, f"res{p}_branch2b_offset", nn.Conv2d(
            mid, deform_groups * 2 * 9, 3, padding=2, dilation=dilation))
        setattr(self, f"res{p}_branch2b_weight",
                nn.Parameter(torch.empty(mid, mid, 3, 3)))
        setattr(self, f"bn{p}_branch2b", FrozenBatchNorm(mid))
        setattr(self, f"res{p}_branch2c", _conv(mid, out, 1))
        setattr(self, f"bn{p}_branch2c", FrozenBatchNorm(out))

    def forward(self, x):
        p = self.prefix
        g = lambda name: getattr(self, name)                       # noqa: E731
        sc = g(f"bn{p}_branch1")(g(f"res{p}_branch1")(x)) if self.has_proj else x
        conv_a = g(f"res{p}_branch2a")
        y = F.relu(g(f"bn{p}_branch2a")(conv_a(x)))
        dt = conv_a.compute_dtype or y.dtype
        offset = g(f"res{p}_branch2b_offset")(y.float())           # NCHW f32
        w = g(f"res{p}_branch2b_weight")
        d = deformable_conv_batched(
            y.to(dt).permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1),
            w.to(dt).permute(2, 3, 1, 0), kernel=3, dilation=self.dilation,
            num_groups=self.deform_groups)
        y = F.relu(g(f"bn{p}_branch2b")(d.to(dt).permute(0, 3, 1, 2)))
        y = g(f"bn{p}_branch2c")(g(f"res{p}_branch2c")(y))
        return F.relu(sc + y)


class ResNet101C5DCN(nn.Module):
    """Deformable res5: three DCNBottlenecks, stride 1, dilation 2, four
    deformable groups (reference resnet_v1_101_rcnn_dcn.py:688-755).
    ``cin``/``mid``/``out`` narrow it for the tests."""

    def __init__(self, cin: int = 1024, mid: int = 512, out: int = 2048):
        super().__init__()
        for i, name in enumerate(_unit_names(5, 3)):
            setattr(self, f"DCNBottleneck_{i}", DCNBottleneck(
                name, cin, mid, out, dilation=2, has_proj=(i == 0)))
            cin = out

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"DCNBottleneck_{i}")(x)
        return x
