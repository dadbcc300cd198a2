"""Square all-vs-all fused (S, N) and AJI: the whole-matrix path.

Counterpart of parfastaai_tpu/ops/pallas_intersect.py ``pallas_fused_aji``,
its dispatch plan ``fused_aji_plan`` and the square TPU kernels behind them:
``_pallas_sn_sym_2p``, ``_pallas_sn_sym``, ``_pallas_sn``,
``_pallas_sn_sym_kb``, ``_pallas_sn_kb`` and the measured alternatives
``_pallas_sn_sym_diag``, ``_pallas_sn_sym_bands`` and
``_pallas_sn_sym_bands_2p``.  All of them compute, for a presence tensor M
(P, G, K) against itself and each protein p in ascending order,

    cnt = M_p . M_p^T
    S  += cnt / (t_p[:, None] + t_p[None, :] - cnt)
    N  += min(cnt, 1)

with T pre-clamped to >= 1 (``sn_rect.clamp_t``).  On the card every route
is one hand-written CUDA kernel, csrc/sn_square_wgmma.cu: int8 counts on
the tensor cores in 128 x 128 tiles, with the block body of
csrc/sn_wgmma.cuh.  Its routes differ in the tiles a launch walks (the
upper triangle or the whole square from a list, the wrapped diagonals, one
band row a launch), in the update (``lean`` / ``base`` and ``f32gram``,
whose exact f32 counts are ``lean``'s values; ``pipe``, ``fused`` /
``mxu_outer`` and ``counts``) and in the rows it stages (0/1 bytes or
nibble-packed).  CUDA tensors go to that kernel, CPU tensors to
``fused_sn_square_plain``, and any other device raises; there is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import MAX_K_SINGLE_BLOCK
from . import _build
from .fused import int_gram
from .sn_rect import _as_int8, accumulator_cell, clamp_t

# Launches of csrc/sn_square_wgmma.cu since the process started (or since a
# caller reset it).
WGMMA_LAUNCHES = 0

# Output tile edge of csrc/sn_square_wgmma.cu (rows and columns per thread
# block), the K bytes it stages per shared-memory slice (K is zero-padded
# to a multiple) and its threads per block: two warpgroups with 64 rows of
# the tile each.  They equal sn_rect's, whose block body it shares
# (csrc/sn_wgmma.cuh), so sn_rect's index maps (``sn_rect.loader_chunks``
# and ``sn_rect.staged_offset`` for each of the two staged sides,
# ``sn_rect.accumulator_cell``) are this kernel's too.
WGMMA_TILE = 128
WGMMA_K_SLICE = 128
WGMMA_THREADS = 256
_MODES = {(False, False): 0, (True, False): 1, (False, True): 2}
# Updates of the two-proteins-per-step body (the 2p variants of the TPU
# kernel): csrc/sn_wgmma.cuh's update codes (kLean, kPipe, kPair, kCounts).
# 'lean' and 'base' run identical code in the JAX package; so do 'fused'
# and 'mxu_outer' on the card (the pair body, whose outer sums ta + tb the
# TPU formed in two ways).  'f32gram' asked for counts that leave the matrix
# unit as f32: exact either way (counts < 2^24), so its values are 'lean''s,
# and 'lean''s int8 body is the fastest way to them on the card (the f16
# peak is half the int8 one, and f16 operands double the staged bytes).
_WGMMA_UPDATES = {"lean": 0, "base": 0, "f32gram": 0, "pipe": 1, "fused": 2,
                  "mxu_outer": 2, "counts": 3}
_VARIANTS = sorted(_WGMMA_UPDATES)
# The two-count-set updates ('pipe', 'fused', 'mxu_outer') hold N in 16-bit
# halves: P stays below this (csrc/sn_wgmma.cuh's kMaxPackedP).
_TWO_SET_CODES = (1, 2)
WGMMA_MAX_PACKED_P = 32768
# csrc/sn_square_wgmma.cu's walks (kWalkList, kWalkDiag, kWalkBand).
_WALK_LIST, _WALK_DIAG, _WALK_BAND = 0, 1, 2


def _check_variant(variant: str) -> None:
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {_VARIANTS}")


def walk_tiles(
    walk: int, nt: int, walk_arg: int = 0, mirror: bool = True
) -> list[tuple[int, int, bool]]:
    """(row tile, column tile, mirrored) of each block of one launch of a
    walk over nt x nt tiles of 128, in block order, as
    csrc/sn_square_wgmma.cu decodes them: the list (the upper triangle, or
    with ``mirror`` off the whole square), the wrapped diagonals
    (i, (i + d) mod nt) for d = 0 .. nt // 2, where a tile mirrors for 0 < d
    unless 2 d == nt (both orientations are walked), or band row
    ``walk_arg`` (r, r .. nt - 1)."""
    if walk == _WALK_LIST:
        tiles = _tile_list(nt, mirror, torch.device("cpu")).tolist()
        return [(r, c, mirror and r != c) for r, c in tiles]
    if walk == _WALK_DIAG:
        return [(i, (i + d) % nt, d != 0 and 2 * d != nt)
                for d in range(nt // 2 + 1) for i in range(nt)]
    r = walk_arg
    return [(r, c, mirror and c != r) for c in range(r, nt)]


def stored_cells(
    tid: int, i: int, rt: int, ct: int, mirrored: bool
) -> list[tuple[int, int]]:
    """(row, column) cells of the G x G output that thread ``tid`` of the
    wgmma kernel's block at tile (rt, ct) stores accumulator element ``i``
    to, as csrc/sn_square_wgmma.cu computes them: the cell itself and, where
    the walk mirrors the tile (``walk_tiles``), its transpose (cells past G
    are masked by the kernel)."""
    r, c = accumulator_cell(tid % 128, i)
    r += rt * WGMMA_TILE + 64 * (tid // 128)
    c += ct * WGMMA_TILE
    return [(r, c), (c, r)] if mirrored else [(r, c)]


def pack_nibbles(m: torch.Tensor) -> torch.Tensor:
    """(..., K) 0/1 bytes -> (..., ceil(K / 2)), two presence columns per
    byte: column 2j in the low nibble, 2j+1 in the high.  An odd K gains one
    zero column first.  Byte-equal to the JAX package's ``_pack_nibbles``
    after ``pallas_fused_aji``'s odd-K pad."""
    if m.shape[-1] % 2:
        m = F.pad(m, (0, 1))
    return (m[..., 0::2] | (m[..., 1::2] << 4)).contiguous()


def fused_aji_plan(
    p: int,
    g: int,
    k: int,
    tile: int | None = None,
    symmetric: bool = True,
    packed: bool = False,
    variant: str = "lean",
) -> dict:
    """The dispatch plan of ``fused_aji`` as data, with the JAX plan's keys.

    ``mode`` equals the JAX package's ``fused_aji_plan`` mode for the same
    arguments ('2p' | 'sym' | 'full' | 'kb_sym' | 'kb_full', with its K
    boundaries at MAX_K_SINGLE_BLOCK // 4 and MAX_K_SINGLE_BLOCK).  The
    ``kb_*`` modes run the same kernel as 'sym' / 'full': the kernel's K
    loop has no fast-memory cap, so K-blocking has nothing to do on the
    card.  The other keys describe what the CUDA kernel really executes.
    ``tile`` is its tile, 128 rows on every route (``variant`` selects the
    update in mode '2p' only).  ``gp`` is G rounded up to it (rows past G
    are masked but their products are computed), ``nt`` and ``n_tiles``
    the tiles walked (triu over-coverage included), ``pp`` the proteins
    multiplied (P: the kernel's protein loop has no steps), ``kp`` the
    presence columns contracted (K padded to the kernel's 128-byte slice;
    packed rows hold two columns a byte, so the kernel reads kp / 2 bytes a
    row) and ``mxu_macs`` = n_tiles * tile^2 * pp * kp.

    The JAX ``auto_tile`` model (v5e rates and VMEM budget) has no
    counterpart: ``tile`` other than None or 128 raises ValueError."""
    _check_variant(variant)
    if packed and k % 2:
        k += 1
    k_eff = k // 2 if packed else k
    blocked = k_eff > MAX_K_SINGLE_BLOCK
    two_per_step = (
        not blocked
        and symmetric
        and not packed
        and k_eff <= MAX_K_SINGLE_BLOCK // 4
    )
    if two_per_step:
        mode = "2p"
    elif blocked:
        mode = "kb_sym" if symmetric else "kb_full"
    else:
        mode = "sym" if symmetric else "full"
    own = WGMMA_TILE
    if tile not in (None, own):
        raise ValueError(
            f"the CUDA kernel's tile on this route is {own}, not {tile}"
        )
    nt = -(-g // own)
    kbytes = -(-k_eff // WGMMA_K_SLICE) * WGMMA_K_SLICE
    kp = 2 * kbytes if packed else kbytes
    n_tiles = nt * (nt + 1) // 2 if symmetric else nt * nt
    return {
        "mode": mode,
        "tile": own,
        "gp": nt * own,
        "nt": nt,
        "n_tiles": n_tiles,
        "pp": p,
        "kp": kp,
        "mxu_macs": n_tiles * own * own * p * kp,
    }


def _counts(a: torch.Tensor, packed: bool) -> torch.Tensor:
    """Exact (G, G) counts of one protein's (G, K) int8 slab against itself;
    packed slabs sum the low- and high-nibble products, as the kernel
    does."""
    if not packed:
        return int_gram(a, a)
    lo, hi = a & 0x0F, (a >> 4) & 0x0F
    return int_gram(lo, lo) + int_gram(hi, hi)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matrix products in full f32 (no TF32 on the card) inside the
    block; the caller's setting is restored after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def fused_sn_square_plain(
    m: torch.Tensor, t: torch.Tensor, *, packed: bool = False,
    update: str = "lean",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version on any device: the full G x G square in the
    kernel's op order (``outer = ta + tb``, ``denom = outer - cf``,
    ``j = cf / denom`` in IEEE f32, ascending proteins).

    ``update`` 'lean' / 'base' add each protein's terms in turn (what the
    kernel gives for one or two proteins per step); 'pipe' does too (its
    carry of a step's counts into the next step changes no value).
    'f32gram' takes each protein's counts as a float32 product of the 0/1
    slab in full f32 (exact: counts < 2^24), then the 'lean' transform.
    'fused' adds each pair of proteins' terms first (``s += j0 + j1``);
    'mxu_outer' does the same with ``ta + tb`` built as the rank-2 product
    ``[ta, 1] @ [1, tb]`` in full f32 (exact: integer ta + tb < 2^24), as
    its TPU body does (the kernel adds ta + tb, which is the same value);
    'counts' adds the pair's f32 counts and leaves N at 0, as the kernel's
    two-proteins-per-step variants do.  An odd last protein forms a pair
    with a zero protein, which adds exactly 0.  The result is
    bit-symmetric: counts are symmetric and ``ta + tb`` commutes.  'pipe'
    and 'f32gram' are bit-equal to 'lean', 'mxu_outer' to 'fused'."""
    _check_variant(update)
    P, G, _ = m.shape
    m8 = _as_int8(m)
    s = torch.zeros((G, G), dtype=torch.float32, device=m.device)
    n = torch.zeros((G, G), dtype=torch.int32, device=m.device)
    step = 2 if update in ("fused", "mxu_outer", "counts") else 1
    for p0 in range(0, P, step):
        terms = []
        for p in range(p0, min(p0 + step, P)):
            if update == "f32gram":
                a = m8[p].to(torch.float32)
                with _full_f32_matmul():
                    cnt = cf = a @ a.T
            else:
                cnt = _counts(m8[p], packed)
                cf = cnt.to(torch.float32)
            if update == "counts":
                terms.append(cf)
                continue
            if update == "mxu_outer":
                ones = torch.ones_like(t[p])
                with _full_f32_matmul():
                    outer = (torch.stack([t[p], ones], 1)
                             @ torch.stack([ones, t[p]], 0))
            else:
                outer = t[p][:, None] + t[p][None, :]
            terms.append(cf / (outer - cf))
            n += cnt.clamp(max=1).to(torch.int32)
        s += terms[0] if len(terms) == 1 else terms[0] + terms[1]
    return s, n


def _check(m: torch.Tensor, t: torch.Tensor) -> None:
    if m.dim() != 3:
        raise ValueError(f"m must be (P, G, K), got {tuple(m.shape)}")
    if tuple(t.shape) != tuple(m.shape[:2]):
        raise ValueError(
            f"t {tuple(t.shape)} does not match (P, G) = {tuple(m.shape[:2])}"
        )
    if m.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"m must be uint8 or int8, got {m.dtype}")
    if t.dtype != torch.float32:
        raise TypeError(f"t must be float32 (see clamp_t), got {t.dtype}")
    if m.device != t.device:
        raise ValueError(
            f"operands lie on different devices: {m.device}, {t.device}"
        )
    for name, x in (("m", m), ("t", t)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=16)
def _tile_list(nt: int, symmetric: bool, device: torch.device) -> torch.Tensor:
    """int32 (n_tiles, 2) (row tile, col tile) on ``device``: the upper
    triangle in row-major order (np.triu_indices, as the TPU wrapper's
    scalar-prefetched maps), or every tile of the square."""
    if symmetric:
        rows, cols = np.triu_indices(nt)
    else:
        rows, cols = np.divmod(np.arange(nt * nt), nt)
    tiles = np.stack([rows, cols], axis=1).astype(np.int32)
    return torch.from_numpy(tiles).to(device)


def _padded(m: torch.Tensor, k_slice: int) -> torch.Tensor:
    """m with K zero-padded to a multiple of the kernel's slice; raises
    unless its first byte is 16-byte aligned (the kernels copy 16 bytes a
    thread)."""
    if m.shape[2] % k_slice:
        m = F.pad(m, (0, k_slice - m.shape[2] % k_slice))
    if m.data_ptr() % 16:
        raise ValueError("m must be 16-byte aligned")
    return m


def _launch_wgmma(
    m: torch.Tensor, t: torch.Tensor, *, symmetric: bool, update: str,
    approx: bool, precise: bool, packed: bool = False, walk: int = _WALK_LIST,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run csrc/sn_square_wgmma.cu with the update of ``update`` on m's CUDA
    device, into one G x G S and N: once over the upper-triangle tiles
    (with the mirror) or every tile of the square (the list walk), once
    over the wrapped diagonals, or once per band row (``walk``; both
    mirror)."""
    global WGMMA_LAUNCHES
    dev = m.device
    P, G, K = m.shape
    code = _WGMMA_UPDATES[update]
    if code in _TWO_SET_CODES and P >= WGMMA_MAX_PACKED_P:
        raise ValueError(
            f"update {update!r} on the wgmma kernel takes P < "
            f"{WGMMA_MAX_PACKED_P} (N in 16-bit halves), not {P}"
        )
    m = _padded(m, WGMMA_K_SLICE)
    K = m.shape[2]
    if G == 0 or P == 0 or K == 0:
        return (torch.zeros((G, G), dtype=torch.float32, device=dev),
                torch.zeros((G, G), dtype=torch.int32, device=dev))
    nt = -(-G // WGMMA_TILE)
    if walk == _WALK_LIST:
        tiles = _tile_list(nt, symmetric, dev)
        launches = [(tiles.data_ptr(), tiles.shape[0], 0)]
    else:
        # (tiles, blocks, walk_arg) of each launch: the kernel decodes the
        # tiles that walk_tiles lists
        args = [nt] if walk == _WALK_DIAG else range(nt)
        launches = [(None, len(walk_tiles(walk, nt, a)), a) for a in args]
    s = torch.empty((G, G), dtype=torch.float32, device=dev)
    n = torch.empty((G, G), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for tiles_ptr, n_blocks, walk_arg in launches:
            rc = lib.sn_square_wgmma_launch(
                m.data_ptr(), t.data_ptr(), tiles_ptr, s.data_ptr(),
                n.data_ptr(), P, G, K, n_blocks, int(symmetric),
                _MODES[(approx, precise)], code, int(packed), walk, walk_arg,
                stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"sn_square_wgmma kernel launch failed: "
                    f"{lib.sn_square_wgmma_error_string(rc).decode()} "
                    f"(cudaError {rc})"
                )
            WGMMA_LAUNCHES += 1
    return s, n


def _route(m, t, approx, precise, name):
    """Validate; True when the operands go to the kernel (CUDA), False for
    the plain version (CPU).  Any other device raises."""
    if approx and precise:
        raise ValueError("approx and precise are mutually exclusive")
    _check(m, t)
    if m.device.type == "cpu":
        return False
    if m.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {m.device}")
    return True


def fused_sn_square(
    m: torch.Tensor,
    t: torch.Tensor,
    *,
    symmetric: bool = True,
    pairs_per_step: int = 1,
    packed: bool = False,
    update: str = "lean",
    approx: bool = False,
    precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(s f32 (G, G), n int32 (G, G)) for m (P, G, K) 0/1 uint8/int8 (or,
    with ``packed``, two nibble columns per byte, ``pack_nibbles``) and t
    (P, G) f32 from ``clamp_t``.

    On CUDA csrc/sn_square_wgmma.cu (128 x 128 tiles) walks the
    upper-triangle tiles and writes each off-diagonal tile's mirror
    (``symmetric``, the TPU's ``_pallas_sn_sym`` / ``_pallas_sn_sym_2p`` /
    ``_pallas_sn_sym_kb``) or every tile (``_pallas_sn`` /
    ``_pallas_sn_kb``), in one launch.  Its protein loop has no steps:
    ``pairs_per_step`` 1 and 2 are the same 'lean' launch there,
    bit-identical by construction.  ``update`` other than 'lean' / 'base'
    selects a 2p variant and needs two proteins per step: 'pipe' adds each
    protein's terms under the next protein's products (bit-equal to
    'lean'), 'fused' and 'mxu_outer' (one launch) count two proteins and add
    ``j0 + j1`` in one epilogue (these three take P < WGMMA_MAX_PACKED_P),
    'counts' adds each pair's f32 count sum and leaves N at 0, and
    'f32gram' (exact f32 counts) runs 'lean'.  ``packed`` runs 'lean' on
    nibble-packed rows, split into low and high nibbles on chip, and needs
    one protein per step.
    ``approx`` selects the raw approximate reciprocal, ``precise`` the IEEE
    divide (bit-identical to the plain version), neither the
    Newton-refined reciprocal.  CPU tensors go to
    ``fused_sn_square_plain``, which always divides in IEEE f32."""
    _check_variant(update)
    if pairs_per_step not in (1, 2):
        raise ValueError(f"pairs_per_step is 1 or 2, not {pairs_per_step}")
    if update not in ("lean", "base") and pairs_per_step != 2:
        raise ValueError(f"update {update!r} needs pairs_per_step=2")
    if packed and pairs_per_step != 1:
        raise ValueError("packed input needs pairs_per_step=1")
    if not _route(m, t, approx, precise, "fused_sn_square"):
        return fused_sn_square_plain(m, t, packed=packed, update=update)
    return _launch_wgmma(m, t, symmetric=symmetric, update=update,
                         packed=packed, approx=approx, precise=precise)


def sn_sym_diag(
    m: torch.Tensor, t: torch.Tensor, *, packed: bool = False,
    approx: bool = False, precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``_pallas_sn_sym_diag``: the tiles (i, (i + d) mod nt)
    for d = 0..nt//2, decoded in closed form from the block index (the
    TPU's affine-mod index maps), (nt//2 + 1) * nt tiles of 128 in one
    launch.  A tile at 0 < d is mirrored unless 2 d == nt: for an even nt
    both orientations of d = nt/2 are computed, and neither mirrors
    (``walk_tiles``).  Same values as ``fused_sn_square``; CPU tensors run
    the plain version."""
    if not _route(m, t, approx, precise, "sn_sym_diag"):
        return fused_sn_square_plain(m, t, packed=packed)
    return _launch_wgmma(m, t, symmetric=True, update="lean", packed=packed,
                         walk=_WALK_DIAG, approx=approx, precise=precise)


def sn_sym_bands(
    m: torch.Tensor, t: torch.Tensor, *, packed: bool = False,
    approx: bool = False, precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``_pallas_sn_sym_bands``: nt launches, band r over the
    tiles (r, r..nt-1) of 128, each writing its band and the band's mirror
    in place into one G x G S/N (the TPU version stitched per-band outputs
    with dynamic_update_slice).  Same values as ``fused_sn_square``; CPU
    tensors run the plain version."""
    if not _route(m, t, approx, precise, "sn_sym_bands"):
        return fused_sn_square_plain(m, t, packed=packed)
    return _launch_wgmma(m, t, symmetric=True, update="lean", packed=packed,
                         walk=_WALK_BAND, approx=approx, precise=precise)


def sn_sym_bands_2p(
    m: torch.Tensor, t: torch.Tensor, *, approx: bool = False,
    precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``_pallas_sn_sym_bands_2p``: ``sn_sym_bands`` with two
    proteins per step, written in place (the counterpart of the TPU
    version's input_output_aliases).  The kernel's protein loop has no
    steps, so it is ``sn_sym_bands``' launches.  Same values as
    ``fused_sn_square``; CPU tensors run the plain version."""
    if not _route(m, t, approx, precise, "sn_sym_bands_2p"):
        return fused_sn_square_plain(m, t)
    return _launch_wgmma(m, t, symmetric=True, update="lean",
                         walk=_WALK_BAND, approx=approx, precise=precise)


def fused_aji(
    m: torch.Tensor,
    t: torch.Tensor,
    tile: int | None = None,
    symmetric: bool = True,
    approx: bool = False,
    packed: bool = False,
    precise: bool = False,
    variant: str = "lean",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-matrix fused AJI: the counterpart of ``pallas_fused_aji``, with
    its signature and contract.

    m is the (P, G, K) 0/1 uint8/int8 presence tensor and t its (P, G)
    rowsums (any numeric dtype; clamped here).  Returns (aji f32, s f32,
    n int32), each (G, G); aji = s / n is NaN where N == 0 and the diagonal
    is each genome's self-AJI.  ``fused_aji_plan`` picks the plan: two
    proteins per step for symmetric, unpacked K <= MAX_K_SINGLE_BLOCK // 4
    (``variant`` then selects the update: 'lean' / 'base', 'pipe',
    'f32gram', 'fused', 'mxu_outer' or the 'counts' diagnostic; see
    ``fused_sn_square``), else one, and ``variant`` has no effect.
    ``symmetric`` walks only the upper-triangle tiles and mirrors them,
    bit-equal to the full square.
    ``packed`` stores two presence columns per byte (``pack_nibbles``;
    counts unchanged) and raises for K > 2 * MAX_K_SINGLE_BLOCK, as the
    TPU package does.  ``approx`` and ``precise`` select the kernel's
    divide (``fused_sn_square``); CPU tensors run the plain version."""
    if approx and precise:
        raise ValueError("approx and precise are mutually exclusive")
    _check_variant(variant)
    P, G, K = m.shape
    plan = fused_aji_plan(P, G, K, tile=tile, symmetric=symmetric,
                          packed=packed, variant=variant)
    if packed and plan["mode"] in ("kb_sym", "kb_full"):
        raise ValueError(
            "packed presence is not supported with K-blocked execution "
            f"(K={K} > {2 * MAX_K_SINGLE_BLOCK}); unpack or use "
            "ops.fused.fused_aji"
        )
    two_per_step = plan["mode"] == "2p"
    s, n = fused_sn_square(
        pack_nibbles(m) if packed else m,
        clamp_t(t),
        symmetric=symmetric,
        pairs_per_step=2 if two_per_step else 1,
        packed=packed,
        update=variant if two_per_step else "lean",
        approx=approx,
        precise=precise,
    )
    return s / n.to(torch.float32), s, n
