"""Decode over several devices: batch sharding and MCU-stripe sharding.

Counterpart of tpujpeg/parallel/sharding.py, name for name.  The JAX
package compiles one program per mesh with shard_map; PyTorch runs
eagerly, so here a mesh is a grid of torch devices and each shard's work
is issued on its own device, one shard after the other (each kernel
wrapper makes its tensors' device current around the launch,
runtime/kernels.launch).  A mesh may name one device more than once: the
CPU tests use ["cpu"] * n and chip_smoke.py [cuda:0] * k.  Shards on one
device share its stream and run one after the other, so such a mesh
shows the logic of several devices, not their speed.

- **Batch parallelism** (`compiled_batch_decoder`): the leading batch
  dimension is split evenly over the mesh's `batch` axis, each shard is
  moved to its device and decoded there by pipeline.device_decode_fn, and
  the outputs stay on their shards, in batch order (JAX's out spec
  P("batch")).  The pixel count (JAX's psum) is computed from the shapes.
  Nothing the decode computed moves between shards.

- **Stripe parallelism** (`decode_striped`): one image's MCU rows are
  split evenly over the `stripe` axis; each stripe decodes its rows on
  its device, fancy vertical upsampling takes one halo row from each
  neighbouring stripe, and the stripes are gathered along H onto the
  mesh's first device.

`TRANSFERS` counts every copy between the shards of a mesh, by kind
("halo", "gather"), also between two shards on one device, so the
counts are the same on the CPU and on one card: the batch path makes
none; the stripe path makes 2 * (n - 1) one-row halo copies per fancy
plane upsampled vertically and one gather per stripe of rgb, and of risk
when the colour is not exact.  The counterpart of
tools/check_collectives.py, which counts the JAX programs' collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import (Geometry, build_plan, decode_subsampled_planes,
                        device_decode_fn, planes_to_rgb)

TRANSFERS = {"halo": 0, "gather": 0}


def reset_transfers() -> None:
    for kind in TRANSFERS:
        TRANSFERS[kind] = 0


def _transfer(t: torch.Tensor, device: torch.device, kind: str):
    """A copy from one shard to another (counted in TRANSFERS[kind])."""
    TRANSFERS[kind] += 1
    return t.to(device)


class Mesh:
    """A (batch, stripe) grid of torch devices: `devices` is a numpy
    object array [n_batch, n_stripe] of torch.device, `shape` maps each
    axis name to its size, as jax.sharding.Mesh does.  Hashable: two
    meshes of the same devices in the same places are equal."""

    axis_names = ("batch", "stripe")

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(
                f"a mesh is a non-empty [n_batch, n_stripe] grid, got shape "
                f"{devices.shape}")
        self.devices = devices
        self._key = (devices.shape, tuple(str(d) for d in devices.flat))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)


def make_mesh(n_batch: int | None = None, n_stripe: int = 1,
              devices=None) -> Mesh:
    """Build a (batch, stripe) mesh of the first n_batch * n_stripe
    `devices` (names or torch.device; one may repeat).

    devices=None takes every card, cuda:0 .. cuda:{device_count() - 1},
    and raises where there is none: the mesh never falls back to the
    CPU.  n_batch=None takes as many batch shards as the devices fill."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card; pass devices= (for example "
                "['cpu'] * n) to build a mesh without one")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    if n_batch is None:
        n_batch = devs.size // n_stripe
    n = n_batch * n_stripe
    if n_batch < 1 or n_stripe < 1 or n > devs.size:
        raise ValueError(f"make_mesh: {n_batch} x {n_stripe} shards need "
                         f"{n} devices, {devs.size} given")
    return Mesh(devs[:n].reshape(n_batch, n_stripe))


# ---------------------------------------------------------------------------
# Batch-parallel decode
# ---------------------------------------------------------------------------


def batched_decode_fn(geom: Geometry, coeffs: torch.Tensor,
                      quant: torch.Tensor, fancy: bool = False,
                      extents: torch.Tensor | None = None,
                      exact: bool = False):
    """The decode of a batch on one device: [B, n_blocks, 64] -> (rgb
    uint8 [B, 3, H, W], riskbits or None when exact).  extents: optional
    int32 [B, 2] true (mcus_y, mcus_x) per image when `geom` is a
    size-class bucket (pipeline.bucket_geometry).  The port's
    device_decode_fn is batched already; this is it with extents."""
    return device_decode_fn(geom, coeffs, quant, fancy=fancy,
                            extents=extents, exact=exact)


def compiled_batch_decoder(geom: Geometry, mesh: Mesh, fancy: bool = False,
                           bucketed: bool = False, exact: bool = False):
    """A batch decode sharded over the mesh's `batch` axis.

    Returns a callable (coeffs, quant[, extents]) -> (rgb, risk, total):
    rgb a list of uint8 [B / n, 3, H, W], one a batch shard in batch
    order, each on its shard's device; risk the same of the packed risk
    bits, or None when exact (the port's strict colour); total the
    decoded pixel count B * W * H as a Python int (JAX's psum), read from
    the shapes with no device read.  B must be divisible by the batch
    axis (ValueError otherwise).  A shard runs on the first device of its
    row of the mesh: the stripe axis replicates the batch decode, as in
    the JAX program, so the port decodes each shard once.

    bucketed=True: `geom` is a bucket and the call takes a third
    argument, int32 [B, 2] true MCU extents (the fancy upsampler's edges);
    rgb and risk cover the bucket's raster and callers crop per image.
    PyTorch compiles nothing, so nothing is cached per geometry."""
    devices = list(mesh.devices[:, 0])
    nb = len(devices)

    def decode(coeffs, quant, extents=None):
        if bucketed != (extents is not None):
            raise ValueError("compiled_batch_decoder: extents go with "
                             "bucketed=True, and only with it")
        B = coeffs.shape[0]
        if B % nb:
            raise ValueError(
                f"batch {B} not divisible by the mesh's batch axis {nb}")
        per = B // nb
        rgbs, risks = [], []
        for i, dev in enumerate(devices):
            part = slice(i * per, (i + 1) * per)
            rgb, risk = batched_decode_fn(
                geom, coeffs[part].to(dev), quant[part].to(dev), fancy=fancy,
                extents=None if extents is None else extents[part].to(dev),
                exact=exact)
            rgbs.append(rgb)
            risks.append(risk)
        return rgbs, None if exact else risks, B * geom.width * geom.height

    return decode


# ---------------------------------------------------------------------------
# Stripe-parallel decode of one huge image
# ---------------------------------------------------------------------------


def stripe_geometry(geom: Geometry, n_stripes: int) -> Geometry:
    """Geometry of one horizontal stripe of `geom` (mcus_y split evenly)."""
    if geom.mcus_y % n_stripes:
        raise ValueError(f"mcus_y={geom.mcus_y} not divisible by {n_stripes}")
    rows = geom.mcus_y // n_stripes
    return Geometry(
        (geom.width, rows * 8 * geom.max_v, geom.mcus_x, rows, geom.comps)
    )


def _halo_extend_rows(planes: list) -> list:
    """Each stripe's plane [B, h, w] with one row of its neighbours' planes
    before and after it (two counted halo copies a boundary).

    At the global top and bottom the stripe's own edge row is replicated
    instead: the edge rule of the unsharded triangle filter, so the
    sharded result is bit-identical to the one-device decode."""
    n = len(planes)
    out = []
    for s, p in enumerate(planes):
        top = p[:, :1] if s == 0 else _transfer(
            planes[s - 1][:, -1:], p.device, "halo")
        bot = p[:, -1:] if s == n - 1 else _transfer(
            planes[s + 1][:, :1], p.device, "halo")
        out.append(torch.cat([top, p, bot], dim=1))
    return out


def _stripe_upsample(sub: Geometry, planes: list, fancy: bool) -> list:
    """Upsample stripe-local planes (planes[s][c]: stripe s, component c);
    fancy vertical filters exchange halos.

    The triangle filter's even and odd output rows read the sample row
    above and below (ops/upsample.py), so a stripe's first and last
    output row pairs need one row of the neighbouring stripes.  The
    upsampler replicates at the edges of what it is given, here the halo
    rows, whose own two output rows at each end are dropped.  Box needs
    no halo."""
    from ..ops.upsample import fancy_upsample, upsample_plane

    out = [[] for _ in planes]
    for c, (h, v, _) in enumerate(sub.comps):
        fh, fv = sub.max_h // h, sub.max_v // v
        if not (fancy and fv == 2 and fh <= 2):
            for s, p in enumerate(planes):
                out[s].append(upsample_plane(p[c], fh, fv, fancy))
            continue
        samples = [torch.clamp(p[c] + 128, 0, 255) for p in planes]
        for s, ext in enumerate(_halo_extend_rows(samples)):
            out[s].append(fancy_upsample(ext, fh, fv)[:, 2:-2] - 128)
    return out


def compiled_stripe_decoder(geom: Geometry, mesh: Mesh, fancy: bool = False,
                            exact: bool = True):
    """A single-image decode with its MCU rows sharded over `stripe`.

    Returns a callable (coeffs [n_blocks, 64], quant [n_comp, 64]) ->
    (rgb uint8 planar [3, H, W], risk bits [H, ceil(W/8)] or None when
    exact) on the mesh's first device, H the MCU-padded height.  coeffs
    split by block into even parts (MCU-row-major order makes an even
    block split an even MCU-row split); stripe s decodes on the s-th
    device of the mesh's first row through the plane path
    (decode_subsampled_planes, `_stripe_upsample`, planes_to_rgb), even
    on 4:4:4, as the JAX program does, so no kernel runs here; then the
    stripes are gathered along H.  exact=True is the reference's colour
    (the port's strict decode), so nothing needs repair."""
    devices = list(mesh.devices[0])
    sub = stripe_geometry(geom, len(devices))
    home = mesh.devices.flat[0]

    def decode(coeffs, quant):
        per = sub.n_blocks
        planes = [
            decode_subsampled_planes(
                sub, coeffs[s * per : (s + 1) * per].to(dev)[None],
                quant.to(dev)[None])
            for s, dev in enumerate(devices)
        ]
        outs = [planes_to_rgb(sub, p, exact=exact)
                for p in _stripe_upsample(sub, planes, fancy)]
        rgb = torch.cat([_transfer(r, home, "gather") for r, _ in outs],
                        dim=2)[0]
        if exact:
            return rgb, None
        risk = torch.cat([_transfer(k, home, "gather") for _, k in outs],
                         dim=1)[0]
        return rgb, risk

    return decode


def decode_striped(img, n_stripes: int | None = None, mesh: Mesh | None = None,
                   strict: bool = True, fancy: bool = False) -> np.ndarray:
    """Decode one image with its MCU rows sharded across devices.

    Host entropy decode -> the stripe-sharded pixel stage -> int32 [H, W,
    3] on the host.  mesh=None is make_mesh(n_batch=1, n_stripe=n_stripes
    or every card).  strict=True computes the reference's exact colour on
    the devices, so the output is bit-exact and nothing is repaired;
    strict=False is the f32 colour.  fancy=True upsamples chroma with the
    triangle filter, exchanging one-row halos between stripes."""
    geom, coeffs, quant = build_plan(img)
    if mesh is None:
        mesh = make_mesh(n_batch=1, n_stripe=n_stripes
                         or torch.cuda.device_count())
    fn = compiled_stripe_decoder(geom, mesh, fancy, exact=strict)
    rgb, _ = fn(torch.as_tensor(coeffs), torch.as_tensor(quant))
    return np.ascontiguousarray(
        rgb.permute(1, 2, 0).cpu().numpy()[: img.height]).astype(np.int32)
