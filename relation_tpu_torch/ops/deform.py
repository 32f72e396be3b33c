"""Deformable ops: deformable convolution and (deformable) position-sensitive
ROI pooling (port of relation_tpu/ops/deform.py).

The math of the JAX package, not its TPU forms: every bilinear sample is
addressed by its four corners directly (the TPU package flattens rows and,
in the pool, multiplies by separable hat rows because gathers are slow
there). Semantics kept
bit-faithful to the original CUDA operators, as in the JAX package:

- the deformable conv samples with ZERO padding outside the map (a sample
  counts when -1 < y < H and -1 < x < W; a corner outside the map adds 0);
- offset channels are [group, tap, (dy, dx)], taps row-major over the kernel;
- the PSROI pool rounds the ROI corners, shifts by -0.5, enforces a 0.1
  minimum size, moves each bin by trans * trans_std * roi size, skips
  samples outside (-0.5, dim - 0.5), clamps the rest into the map, divides by
  the count of in-range samples and gives 0 where that count is 0.

The deformable conv has ONE backward (the JAX package's
RELATION_TPU_DEFORM_VJP modes 'hat', 'scatter' and 'autodiff' are TPU A/B
switches and are not ported): dcol and dw are matrix products, doffset
recomputes the four corners, and dx is the col2im kernel
(ops/kernels/dconv_col2im.py: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors).

Dtype policy of the JAX call sites: x and the weight arrive in the conv's
compute dtype (bf16 on the card), offsets are f32, products accumulate in
f32; the interpolation factors and the corner values of the offset gradient
ride the compute dtype, the sum over a group's channels is f32.
"""

from __future__ import annotations

import torch

from relation_tpu_torch.ops.kernels.dconv_col2im import dconv_col2im


def _tap_coords(offset: torch.Tensor, k: int, stride: int, dilation: int,
                pad: int, G: int):
    """Sample coordinates of every output position, tap and group:
    (yy, xx) each [B, Ho, Wo, k*k, G] f32."""
    B, Ho, Wo, _ = offset.shape
    dev = offset.device
    off = offset.reshape(B, Ho, Wo, G, k * k, 2).to(torch.float32)
    base_y = (torch.arange(Ho, dtype=torch.float32, device=dev) * stride - pad)
    base_x = (torch.arange(Wo, dtype=torch.float32, device=dev) * stride - pad)
    tap = torch.arange(k, dtype=torch.float32, device=dev) * dilation
    tap_y, tap_x = tap.repeat_interleave(k), tap.repeat(k)          # [kk]
    yy = (base_y.view(1, Ho, 1, 1, 1) + tap_y.view(1, 1, 1, -1, 1)
          ) + off[..., 0].transpose(3, 4)
    xx = (base_x.view(1, 1, Wo, 1, 1) + tap_x.view(1, 1, 1, -1, 1)
          ) + off[..., 1].transpose(3, 4)
    return yy, xx


def _inside(yy, xx, H: int, W: int):
    """(inside, yz, xz): the zero-extension guard and the coordinates with
    the samples outside set to 0."""
    inside = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    zero = torch.zeros_like(yy)
    return inside, torch.where(inside, yy, zero), torch.where(inside, xx, zero)


def _corner_values(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, G: int):
    """The four corner values of every sample, zero for a corner outside the
    map. x [B, H, W, C]; y0, x0 [B, Ho, Wo, kk, G] (floored coordinates) ->
    (v00, v01, v10, v11) each [B, Ho, Wo, kk, G, cg]."""
    B, H, W, C = x.shape
    cg = C // G
    xr = x.reshape(B * H * W * G, cg)        # row = ((b*H + y)*W + x)*G + g
    b_idx = torch.arange(B, device=x.device).view(B, 1, 1, 1, 1)
    g_idx = torch.arange(G, device=x.device).view(1, 1, 1, 1, G)

    def corner(yc, xc):
        ok = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
        yi = yc.clamp(0, H - 1).long()
        xi = xc.clamp(0, W - 1).long()
        r = ((b_idx * H + yi) * W + xi) * G + g_idx
        v = xr[r.reshape(-1)].view(*r.shape, cg)
        return v * ok[..., None]

    return (corner(y0, x0), corner(y0, x0 + 1), corner(y0 + 1, x0),
            corner(y0 + 1, x0 + 1))


def _col(x: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor, G: int):
    """Deformable im2col: col [B, Ho, Wo, kk, C], zero outside the map."""
    B, H, W, C = x.shape
    inside, yz, xz = _inside(yy, xx, H, W)
    y0, x0 = torch.floor(yz), torch.floor(xz)
    ly = (yz - y0).to(x.dtype)[..., None]
    lx = (xz - x0).to(x.dtype)[..., None]
    v00, v01, v10, v11 = _corner_values(x, y0, x0, G)
    col = (v00 * ((1 - ly) * (1 - lx)) + v01 * ((1 - ly) * lx)
           + v10 * (ly * (1 - lx)) + v11 * (ly * lx)) * inside[..., None]
    return col.reshape(*yy.shape[:4], C)


class _DeformConv(torch.autograd.Function):
    """Batched deformable conv with the hand-written backward of
    relation_tpu/ops/deform.py::_dconv_bwd_b."""

    @staticmethod
    def forward(ctx, x, offset, weights, k, stride, dilation, pad, G):
        yy, xx = _tap_coords(offset, k, stride, dilation, pad, G)
        col = _col(x, yy, xx, G)                       # [B, Ho, Wo, kk, C]
        B, Ho, Wo, kk, C = col.shape
        out = col.reshape(B * Ho * Wo, kk * C) @ weights.reshape(kk * C, -1)
        ctx.save_for_backward(x, offset, weights, col)
        ctx.conf = (k, stride, dilation, pad, G)
        return out.view(B, Ho, Wo, -1)

    @staticmethod
    def backward(ctx, dout):
        x, offset, weights, col = ctx.saved_tensors
        k, stride, dilation, pad, G = ctx.conf
        need_x, need_off, need_w = ctx.needs_input_grad[:3]
        B, H, W, C = x.shape
        _, Ho, Wo, kk, _ = col.shape
        cg, Q = C // G, Ho * Wo
        dout2 = dout.reshape(B * Q, -1).to(col.dtype)
        dx = doff = dw = None
        if need_w:
            dw = (col.reshape(B * Q, kk * C).t() @ dout2).view(weights.shape)
        if not (need_x or need_off):
            return dx, doff, dw, None, None, None, None, None
        # [B*Q, kk*C]: rows in (b, q, tap, group) order, cg channels each
        dcol = dout2 @ weights.reshape(kk * C, -1).t()
        yy, xx = _tap_coords(offset, k, stride, dilation, pad, G)
        inside, yz, xz = _inside(yy, xx, H, W)
        if need_x:
            # the col2im kernel; samples (q, tap) of one (b, g) in dcol's order
            dx = dconv_col2im(
                yz.reshape(B, Q * kk, G), xz.reshape(B, Q * kk, G),
                inside.reshape(B, Q * kk, G), dcol.view(B, Q * kk, G, cg),
                H, W).to(x.dtype)
        if need_off:
            y0, x0 = torch.floor(yz), torch.floor(xz)
            ly = (yz - y0).to(x.dtype)[..., None]
            lx = (xz - x0).to(x.dtype)[..., None]
            v00, v01, v10, v11 = _corner_values(x, y0, x0, G)
            d = dcol.view(B, Ho, Wo, kk, G, cg)
            gy = (v10 - v00) * (1 - lx) + (v11 - v01) * lx
            gx = (v01 - v00) * (1 - ly) + (v11 - v10) * ly
            m = inside.to(torch.float32)
            ddy = (d * gy).sum(-1, dtype=torch.float32) * m
            ddx = (d * gx).sum(-1, dtype=torch.float32) * m
            # [B, Ho, Wo, kk, G, 2] -> the offset's [.., G, kk, (dy, dx)]
            doff = (torch.stack([ddy, ddx], -1).transpose(3, 4)
                    .reshape(offset.shape).to(offset.dtype))
        return dx, doff, dw, None, None, None, None, None


def deformable_conv_batched(x: torch.Tensor, offset: torch.Tensor,
                            weights: torch.Tensor, kernel: int = 3,
                            stride: int = 1, dilation: int = 1,
                            pad: int | None = None,
                            num_groups: int = 4) -> torch.Tensor:
    """Batched deformable convolution (deformable im2col + matrix product).

    x [B, H, W, C]; offset [B, Ho, Wo, num_groups * 2 * k * k] with per-group
    (dy, dx) per tap; weights [k, k, C, Cout] (the JAX package's layouts).
    Returns [B, Ho, Wo, Cout] in the dtype of x (products accumulate in
    f32). x and weights share a dtype; offsets are used in f32."""
    k = kernel
    if pad is None:
        pad = ((k - 1) // 2) * dilation
    if x.dim() != 4 or offset.dim() != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"deformable_conv_batched: x {tuple(x.shape)}, offset "
                         f"{tuple(offset.shape)}, {num_groups} groups")
    if offset.shape[-1] != num_groups * 2 * k * k:
        raise ValueError(f"deformable_conv_batched: {offset.shape[-1]} offset "
                         f"channels for {num_groups} groups of {k}x{k} taps")
    return _DeformConv.apply(x.contiguous(), offset.contiguous(),
                             weights.contiguous(), k, stride, dilation, pad,
                             num_groups)


def deformable_conv(x: torch.Tensor, offset: torch.Tensor, weights: torch.Tensor,
                    kernel: int = 3, stride: int = 1, dilation: int = 1,
                    pad: int | None = None, num_groups: int = 4) -> torch.Tensor:
    """Deformable convolution of one image: x [H, W, C], offset
    [Ho, Wo, num_groups * 2 * k * k], weights [k, k, C, Cout] ->
    [Ho, Wo, Cout]. The batched op on a batch of one."""
    return deformable_conv_batched(x[None], offset[None], weights, kernel,
                                   stride, dilation, pad, num_groups)[0]


def deformable_psroi_pool(feat: torch.Tensor, rois: torch.Tensor,
                          trans: torch.Tensor | None, spatial_scale: float,
                          pooled_size: int = 7, group_size: int = 1,
                          sample_per_part: int = 4, trans_std: float = 0.1,
                          output_dim: int | None = None,
                          part_size: int | None = None) -> torch.Tensor:
    """(Deformable) position-sensitive ROI pooling of one image.

    feat [H, W, C]; rois [R, 4]; trans [R, 2, part, part] or None (plain
    PSROI average pooling with the same rounding and sampling scheme).
    Returns [R, P, P, output_dim] in feat's dtype. Channel of bin (ph, pw)
    and output channel ctop: (ctop * G + gh) * G + gw with
    gh = floor(ph * G / P); with group_size 1 (the detection heads) every
    bin reads every channel. Coordinates and corner weights are computed in
    f32 and cast to feat's dtype; products accumulate in f32.

    group_size 1: the S*S*4 corner weights of a bin are added into its row
    of a [bins, H*W] matrix, and the pool is that matrix times the
    [H*W, C] map, so that the backward is two matrix products as well. (A
    gather of the corners has an index_put for its backward, which
    serialises over the pixels that many ROIs share: 35 ms a pool at 316
    clustered ROIs on an H100.) group_size > 1: each bin gathers its corners
    from its own plane and is one [1, S*S*4] x [S*S*4, channels] product.
    Differentiable in feat and trans."""
    H, W, C = feat.shape
    P, G, S = pooled_size, group_size, sample_per_part
    output_dim = output_dim or C // (G * G)
    part_size = part_size or P
    R = rois.shape[0]
    dev = feat.device
    rois = rois.to(torch.float32)

    start_w = torch.round(rois[:, 0]) * spatial_scale - 0.5
    start_h = torch.round(rois[:, 1]) * spatial_scale - 0.5
    end_w = (torch.round(rois[:, 2]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    roi_w = (end_w - start_w).clamp_min(0.1)
    roi_h = (end_h - start_h).clamp_min(0.1)
    bin_w, bin_h = roi_w / P, roi_h / P                           # [R]
    sub_w, sub_h = bin_w / S, bin_h / S

    p = torch.arange(P, dtype=torch.float32, device=dev)
    s = torch.arange(S, dtype=torch.float32, device=dev)
    wstart = (p[None, :] * bin_w[:, None])[:, None, :] + start_w[:, None, None]
    hstart = (p[None, :] * bin_h[:, None])[:, :, None] + start_h[:, None, None]
    if trans is not None:
        part = torch.floor(p / P * part_size).long()
        t = trans.to(torch.float32)[:, :, part][:, :, :, part]    # [R, 2, P, P]
        wstart = wstart + t[:, 0] * trans_std * roi_w[:, None, None]
        hstart = hstart + t[:, 1] * trans_std * roi_h[:, None, None]
    full = (R, P, P, S, S)                                        # (ph, pw, ih, iw)
    xs = (wstart[..., None, None]
          + (s[None, :] * sub_w[:, None])[:, None, None, None, :]).expand(full)
    ys = (hstart[..., None, None]
          + (s[None, :] * sub_h[:, None])[:, None, None, :, None]).expand(full)

    ok = (xs > -0.5) & (xs < W - 0.5) & (ys > -0.5) & (ys < H - 0.5)
    xc = xs.clamp(0.0, W - 1.0)
    yc = ys.clamp(0.0, H - 1.0)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    y1 = (y0 + 1).clamp_max(H - 1.0)
    x1 = (x0 + 1).clamp_max(W - 1.0)
    ly, lx = yc - y0, xc - x0
    okf = ok.to(torch.float32)
    wts = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx),
                       ly * lx], -1) * okf[..., None]             # [R,P,P,S,S,4]
    pix = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1],
                      -1).long()
    bins, n = R * P * P, S * S * 4
    if G == 1:
        rows = torch.arange(bins, device=dev).view(bins, 1) * (H * W)
        mat = torch.zeros(bins * H * W, dtype=torch.float32, device=dev)
        mat = mat.index_add(0, (rows + pix.view(bins, n)).reshape(-1),
                            wts.reshape(-1))
        summed = mat.view(bins, H * W).to(feat.dtype) @ feat.reshape(H * W, C)
    else:
        # one plane of output_dim channels per (gh, gw)
        flat = (feat.reshape(H * W, output_dim, G * G).permute(2, 0, 1)
                .reshape(G * G * H * W, output_dim))
        gi = torch.tensor([min(max(int(ph * G / P), 0), G - 1) for ph in range(P)],
                          device=dev)
        plane = gi[:, None] * G + gi[None, :]                     # [P, P]
        pix = pix + (plane * (H * W)).view(1, P, P, 1, 1, 1)
        v = flat[pix.reshape(-1)].view(bins, n, output_dim)
        summed = torch.bmm(wts.reshape(bins, 1, n).to(feat.dtype), v)[:, 0]
    cnt = okf.sum((3, 4)).reshape(bins, 1).to(feat.dtype)
    out = torch.where(cnt > 0, summed / cnt.clamp_min(1), torch.zeros_like(summed))
    return out.view(R, P, P, -1)[..., :output_dim]
