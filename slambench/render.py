"""The blob world rendered with torch, on the device that holds the world.

The arithmetic of the test suite's ``render_scene`` (frozen in
``render_np.py``): square billboards painted far to near at 2x
supersampling, each with its own micro-texture tile stretched over it, a
1.2 m near-plane cull, then a 2x2 box downsample. Painting far to near
leaves each pixel to the nearest blob that covers it, so one scatter of
the blobs' depth ranks over their pixels (``amin``) gives the same image
without a loop over blobs.
"""

from __future__ import annotations

import torch

SS = 2  # supersampling factor
NEAR_M = 1.2
BG = 128.0


def render(world: dict, T: torch.Tensor, K4, h: int, w: int) -> torch.Tensor:
    """(h, w) float32 image of `world` (tensors xw, intensity, size, tiles
    on one device) seen from world-to-camera pose T (3, 4)."""
    xw, inten, size, tiles = world["xw"], world["intensity"], world["size"], world["tiles"]
    dev = xw.device
    fx, fy, cx, cy = K4
    H, W = h * SS, w * SS
    P = tiles.shape[-1]
    xc = xw @ T[:, :3].T + T[:, 3]
    z = xc[:, 2]
    zs = torch.clamp_min(z, 1e-6)
    u = SS * (fx * xc[:, 0] / zs + cx)
    v = SS * (fy * xc[:, 1] / zs + cy)
    ri = torch.round(torch.clamp(SS * size * fx / zs, SS, SS * 80)).long()
    yc, xcen = torch.round(v).long(), torch.round(u).long()
    y0, y1, x0, x1 = yc - ri, yc + ri, xcen - ri, xcen + ri
    cy0, cy1 = y0.clamp_min(0), y1.clamp(0, H)
    cx0, cx1 = x0.clamp_min(0), x1.clamp(0, W)
    keep = (z > NEAR_M) & (cy1 > cy0) & (cx1 > cx0)
    img = torch.full((H * W,), BG, dtype=torch.float32, device=dev)
    b = torch.nonzero(keep).squeeze(1)
    if b.numel():
        # Depth rank of each kept blob: the nearest paints last.
        b = b[torch.argsort(z[b], stable=True)]
        ny, nx = cy1[b] - cy0[b], cx1[b] - cx0[b]
        counts = ny * nx
        total = int(counts.sum())
        rank = torch.repeat_interleave(torch.arange(b.numel(), device=dev), counts,
                                       output_size=total)
        start = torch.cumsum(counts, 0) - counts
        local = torch.arange(total, device=dev) - start[rank]
        py = cy0[b][rank] + local // nx[rank]
        px = cx0[b][rank] + local % nx[rank]
        pix = py * W + px
        NONE = b.numel()
        top = torch.full((H * W,), NONE, dtype=torch.long, device=dev)
        top.scatter_reduce_(0, pix, rank, reduce="amin")
        hit = torch.nonzero(top < NONE).squeeze(1)
        k = b[top[hit]]
        side = 2 * ri[k]
        ty = ((hit // W - y0[k]) * P // side).clamp(0, P - 1)
        tx = ((hit % W - x0[k]) * P // side).clamp(0, P - 1)
        img[hit] = torch.clamp(inten[k] * tiles[k, ty, tx], 0, 255)
    return img.view(h, SS, w, SS).mean(dim=(1, 3))


def right_pose(T: torch.Tensor, baseline: float) -> torch.Tensor:
    """World-to-camera pose of the right camera of a rectified rig whose
    left camera is at T: x_c_right = x_c_left - [baseline, 0, 0]."""
    Tr = T.clone()
    Tr[0, 3] -= baseline
    return Tr


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """8-bit image as a camera delivers it (truncation, as numpy's astype)."""
    return torch.clamp(img, 0, 255).to(torch.uint8)


def render_sequence(world: dict, poses, K4, h: int, w: int, device,
                    baseline: float | None = None):
    """uint8 frames of every pose, rendered on `device` and returned as one
    host numpy array: (F, h, w), or (F, 2, h, w) left and right for a
    stereo rig of `baseline` m."""
    wd = {k: torch.as_tensor(world[k], device=device)
          for k in ("xw", "intensity", "size", "tiles")}
    Ts = torch.as_tensor(poses, device=device)
    views = 1 if baseline is None else 2
    out = torch.empty((len(Ts), views, h, w), dtype=torch.uint8, device=device)
    for i, T in enumerate(Ts):
        out[i, 0] = to_u8(render(wd, T, K4, h, w))
        if baseline is not None:
            out[i, 1] = to_u8(render(wd, right_pose(T, baseline), K4, h, w))
    frames = out.cpu().numpy()
    return frames[:, 0] if baseline is None else frames
