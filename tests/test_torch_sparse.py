"""The port's unstructured ELL operators (``repro_torch.linalg.sparse``),
its ELL kernel's plain version and the ice-sheet config, held against the
JAX package on small meshes (at most 400 nodes).

Tolerances:
* Construction is the same host numpy in both packages: ``cols``,
  ``vals``, the RCM permutation, the bandwidth and ``eig_bounds`` are
  compared for exact equality.
* ``SparseOp.apply`` keeps the ``ell_rowsum`` chain in both packages,
  but XLA may contract a multiply-add into one FMA: 1e-13 relative to
  sum(|A||x|) per row.
* ``ell_spmv_ref`` sums the slots left to right while the JAX oracle and
  its Pallas kernel use ``.sum(axis=1)``: per row |diff| <= 1e-13 *
  sum_s |v x| in fp64, and <= 1e-5 * sum_s |v x| in fp32 (about 80 ulps
  of fp32 for an 11-term sum taken in another order).
"""

import dataclasses
import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda tests; where JAX is
# installed, the reference package is imported unguarded.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro.configs import icesheet3d as jice
    from repro.configs.problems import build_operator as jbuild
    from repro.kernels import ops as jkops
    from repro.kernels import ref as jref
    from repro.linalg import sparse as jsp

from repro_torch import convert  # noqa: E402
from repro_torch.configs import icesheet3d as tice  # noqa: E402
from repro_torch.configs.problems import build_operator as tbuild  # noqa: E402
from repro_torch.core import pipelined_cg as tpc  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.kernels import ell_spmv as tel  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.linalg import BlockJacobi, JacobiPrec  # noqa: E402
from repro_torch.linalg import sparse as tsp  # noqa: E402

RTOL = 1e-13


def _launches(name):
    from repro_torch.kernels import _build

    return _build.LAUNCHES[name]


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _same_arrays(jop, top):
    np.testing.assert_array_equal(top.cols.numpy(), np.asarray(jop.cols))
    np.testing.assert_array_equal(top.vals.numpy(), np.asarray(jop.vals))
    assert top.vals.dtype == torch.float64 and top.cols.dtype == torch.int32
    assert (top.n, top.w, top.nnz, top.ordered) == (jop.n, jop.w, jop.nnz,
                                                    jop.ordered)


@pytest.mark.parametrize("gen", ["mesh", "icesheet"])
def test_generators_rcm_and_bounds_match_jax(gen, with_jax):
    if gen == "mesh":
        jop = jsp.random_fem_mesh(5, 300)
        top = tsp.random_fem_mesh(5, 300, device="cpu")
    else:
        jop = jsp.random_fem_icesheet(48, 10, 6, 4, eps_z=0.01)
        top = tsp.random_fem_icesheet(48, 10, 6, 4, eps_z=0.01,
                                      device="cpu")
    _same_arrays(jop, top)
    np.testing.assert_array_equal(tsp.rcm_permutation(top),
                                  jsp.rcm_permutation(jop))
    jr, jperm = jsp.rcm_reorder(jop)
    tr, tperm = tsp.rcm_reorder(top)
    np.testing.assert_array_equal(tperm, jperm)
    _same_arrays(jr, tr)
    assert tsp.bandwidth(tr) == jsp.bandwidth(jr)
    assert tsp.bandwidth(top) == jsp.bandwidth(jop)
    assert tr.eig_bounds() == jr.eig_bounds()
    np.testing.assert_array_equal(tr.to_dense(), jr.to_dense())
    np.testing.assert_array_equal(tr.diag().numpy(), np.asarray(jr.diag()))


def test_config_builds_the_jax_operator(with_jax):
    jop = jbuild(jice.smoke_config())
    top = tbuild(tice.smoke_config(), "cpu")
    assert isinstance(top, tsp.SparseOp) and top.n == 240
    _same_arrays(jop, top)
    assert dataclasses.asdict(tice.config()) == dataclasses.asdict(
        jice.config())
    assert dataclasses.asdict(tice.smoke_config()) == dataclasses.asdict(
        jice.smoke_config())


def test_coo_and_dense_packing_match_jax(with_jax):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((9, 9)) * (rng.uniform(size=(9, 9)) < 0.3)
    a = a + a.T + 9 * np.eye(9)
    _same_arrays(jsp.sparse_from_dense(a), tsp.sparse_from_dense(
        a, device="cpu"))
    rows = rng.integers(0, 7, 30)
    cols = rng.integers(0, 7, 30)
    vals = rng.standard_normal(30)
    _same_arrays(jsp.sparse_from_coo(7, rows, cols, vals),
                 tsp.sparse_from_coo(7, rows, cols, vals, device="cpu"))
    with pytest.raises(ValueError):
        tsp.sparse_from_coo(3, [0, 5], [0, 1], [1.0, 2.0], device="cpu")


def test_apply_matches_jax_and_kernel_route_is_plain_on_cpu(with_jax):
    jop = jbuild(jice.smoke_config())
    top = tbuild(tice.smoke_config(), "cpu")
    x = np.random.default_rng(3).standard_normal(top.n)
    yt = top.apply(torch.as_tensor(x)).numpy()
    yj = np.asarray(jop.apply(jnp.asarray(x)))
    scale = np.abs(top.to_dense()) @ np.abs(x)
    np.testing.assert_array_less(np.abs(yt - yj), RTOL * scale + 1e-300)
    kop = dataclasses.replace(top, use_kernel=True)
    assert torch.equal(kop.apply(torch.as_tensor(x)), torch.as_tensor(yt))
    np.testing.assert_allclose(yt, top.to_dense() @ x, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("r,w,nx", [(100, 7, 100), (37, 5, 60)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ell_spmv_ref_matches_jax_kernel_and_oracle(r, w, nx, dtype,
                                                    with_jax):
    """``nx > r``: x longer than the row count (the distributed path's
    [own | halo] vector)."""
    rng = np.random.default_rng(r + w)
    x = rng.standard_normal(nx).astype(dtype)
    cols = rng.integers(0, nx, size=(r, w)).astype(np.int32)
    vals = rng.standard_normal((r, w)).astype(dtype)
    # zero a padding tail per row, as the ELL packer produces
    nnz = rng.integers(1, w + 1, size=(r,))
    vals[np.arange(w)[None, :] >= nnz[:, None]] = 0
    yt = tel.ell_spmv(torch.as_tensor(x), torch.as_tensor(cols),
                      torch.as_tensor(vals))
    assert yt.dtype == getattr(torch, dtype)
    assert torch.equal(yt, tref.ell_spmv_ref(torch.as_tensor(x),
                                             torch.as_tensor(cols),
                                             torch.as_tensor(vals)))
    bound = (1e-13 if dtype == "float64" else 1e-5) * (
        np.abs(vals.astype(np.float64))
        * np.abs(x.astype(np.float64)[cols])).sum(axis=1)
    for yj in (jkops.ell_spmv_apply(jnp.asarray(x), jnp.asarray(cols),
                                    jnp.asarray(vals)),
               jref.ell_spmv_ref(jnp.asarray(x), jnp.asarray(cols),
                                 jnp.asarray(vals))):
        diff = np.abs(yt.numpy().astype(np.float64)
                      - np.asarray(yj).astype(np.float64))
        np.testing.assert_array_less(diff, bound + 1e-300)


def test_convert_round_trips_sparse(with_jax):
    jop = jbuild(jice.smoke_config())
    top = convert.operator("ell", device="cpu", cols=np.asarray(jop.cols),
                           vals=np.asarray(jop.vals), ordered=jop.ordered,
                           use_kernel=jop.use_kernel)
    _same_arrays(jop, top)
    fields = convert.operator_fields(top)
    assert fields.pop("kind") == "ell"
    back = jsp.SparseOp(cols=jnp.asarray(fields["cols"]),
                        vals=jnp.asarray(fields["vals"]),
                        ordered=fields["ordered"],
                        use_kernel=fields["use_kernel"])
    _same_arrays(back, top)


def test_refusals():
    op = tbuild(tice.smoke_config(), "cpu")
    kop = dataclasses.replace(op, use_kernel=True)
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(op.n))
    with pytest.raises(ValueError, match="fused_iter_factory"):
        tpc.solve(SolverOps.local(kop, JacobiPrec.from_operator(op)), b, 2,
                  fused_iteration=True)
    # Block-Jacobi is ported; a block size that does not divide n, and
    # the fused path with it (none, as in the JAX package), are refused.
    with pytest.raises(ValueError, match="does not divide"):
        BlockJacobi.from_operator(op, 7)
    with pytest.raises(ValueError, match="fused_iter_factory"):
        tpc.solve(SolverOps.local(op, BlockJacobi.from_operator(op, 8)), b, 2,
                  fused_iteration=True)
    with pytest.raises(ValueError, match="device"):
        meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
        tel.ell_spmv(torch.empty(4, device="meta"), meta,
                     torch.empty((4, 2), device="meta"))
    with pytest.raises(ValueError, match="one \\(n, w\\)"):
        tsp.SparseOp(cols=np.zeros((3, 2), np.int32), vals=np.zeros((3, 1)),
                     device="cpu")


@pytest.mark.parametrize("rows", [1, 256, 4097])
@pytest.mark.parametrize("w,itemsize", [(11, 8), (12, 4), (27, 8), (1, 8),
                                        (400, 8)])
def test_ell_plan_covers_every_row_once(rows, w, itemsize):
    """The kernel's launch plan, for aligned and misaligned bases: walked
    in the staged kernel's order (tile t = b, b + grid, ... for block b;
    bulk tiles first), every row (and so every slot) lies in exactly one
    tile of one block; a bulk-copied tile is full and its cols/vals spans
    start and end on 16-byte boundaries; a misaligned base sends every tile
    through ordinary loads; an operator too wide to stage runs the direct
    kernel; the grid is one wave."""
    sms, per_sm = 132, 3
    for offsets in ((0, 0), (4, 8), (0, 8)):
        p = tel.plan(rows, w, itemsize, offsets[0], offsets[1], sms,
                     lambda threads, smem: per_sm)
        _check_ell_plan(p, rows, w, itemsize, offsets, sms, per_sm)


def _check_ell_plan(p, rows, w, itemsize, offsets, sms, per_sm):
    fits = tel.STAGES * 32 * w * (itemsize + 4) <= tel.STAGE_BUDGET
    assert p.staged == fits
    seen = np.zeros(rows, np.int64)
    if not p.staged:          # the direct kernel: a block's threads' rows
        for blk in range(p.grid):
            seen[blk * p.tile_rows:(blk + 1) * p.tile_rows] += 1
        assert (seen == 1).all() and p.bulk_tiles == 0
        return
    for blk in range(p.grid):
        for t in range(blk, p.tiles, p.grid):
            r0 = t * p.tile_rows
            nr = min(p.tile_rows, rows - r0)
            seen[r0:r0 + nr] += 1
            if t < p.bulk_tiles:
                assert nr == p.tile_rows
                for off, size in ((offsets[0], 4), (offsets[1], itemsize)):
                    assert (off + r0 * w * size) % tel.BULK_ALIGN == 0
                    assert (nr * w * size) % tel.BULK_ALIGN == 0
    assert (seen == 1).all()
    assert p.tile_rows % 32 == 0 and p.tiles == -(-rows // p.tile_rows)
    assert p.smem_bytes == p.stages * p.tile_rows * w * (itemsize + 4)
    assert p.smem_bytes <= tel.STAGE_BUDGET
    assert 1 <= p.grid <= min(p.tiles, sms * per_sm)
    aligned = offsets[0] % 16 == 0 and offsets[1] % 16 == 0
    assert p.bulk_tiles == (rows // p.tile_rows if aligned else 0)


def _ell_case(rng, rows, w, nx, dev, offset=0):
    """A random (rows, w) ELL operator on ``dev`` with a few padded slots
    (column 0, value 0), its cols/vals starting ``offset`` elements into
    their buffers."""
    cols = rng.integers(0, nx, (rows, w)).astype(np.int32)
    vals = rng.standard_normal((rows, w))
    pad = rng.random((rows, w)) < 0.2
    pad[:, 0] = False
    cols[pad], vals[pad] = 0, 0.0
    cbuf = torch.zeros(rows * w + offset, dtype=torch.int32, device=dev)
    vbuf = torch.zeros(rows * w + offset, dtype=torch.float64, device=dev)
    cbuf[offset:] = torch.as_tensor(cols.ravel(), device=dev)
    vbuf[offset:] = torch.as_tensor(vals.ravel(), device=dev)
    return cbuf[offset:].view(rows, w), vbuf[offset:].view(rows, w)


@pytest.mark.cuda
def test_ell_kernels_bitwise_on_card(cuda_device):
    from repro_torch.kernels import fused_iter as tfi
    from repro_torch.kernels.ops import fused_iteration_factory

    op = tsp.random_fem_icesheet(48, 10, 6, 4, device=cuda_device)
    op = tsp.rcm_reorder(op)[0]
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal(op.n + 7), device=cuda_device)
    for dt in (torch.float64, torch.float32):
        v = op.vals.to(dt)
        assert torch.equal(tel.ell_spmv(x, op.cols, v),
                           tel.ell_spmv_plain(x, op.cols, v))
    # Every path of the kernel, reached by its input: bulk copies with a
    # ragged or exact tile count, fewer rows than a tile, odd and even W, x
    # longer than R; ordinary loads for bases off the 16-byte grid; and a W
    # too wide to stage (the direct kernel).
    for rows, w, off in ((1000, 11, 0), (1000, 11, 1), (512, 12, 0),
                         (5, 11, 0), (4097, 27, 3), (100, 400, 0)):
        cols, vals = _ell_case(rng, rows, w, rows + 13, cuda_device, off)
        xx = torch.tensor(rng.standard_normal(rows + 13), device=cuda_device)
        for dt in (torch.float64, torch.float32):
            v = vals.to(dt) if dt != vals.dtype else vals
            before = _launches("ell_spmv")
            got = tel.ell_spmv(xx, cols, v)
            assert _launches("ell_spmv") == before + 1
            assert torch.equal(got, tel.ell_spmv_plain(xx, cols, v)), (
                rows, w, off, dt)
    prec = JacobiPrec.from_operator(op)
    for l in (1, 2, 3, 8):
        for rec in ("ghysels", "stable"):
            layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
            fiter = fused_iteration_factory(op, prec)(layout)
            for i in (0, l, 2 * l + 3):
                IS = tfi.scal_layout(l)
                scal = rng.standard_normal(IS["size"])
                scal[IS["dlt_safe"]] = 1.25
                scal[IS["eta_new_safe"]] = 0.75
                scal[IS["eta0_safe"]] = 1.5
                S, idx, sc = convert.vector_phase(
                    rng.standard_normal((layout.nv, op.n)),
                    tfi.host_idx(layout, i), scal, cuda_device)
                S_p, d_p = fiter.plain(S, idx, sc)
                S_k, d_k = fiter(S.clone(), idx, sc)
                assert torch.equal(S_k, S_p)
                torch.testing.assert_close(d_k, d_p, rtol=1e-12, atol=1e-12)


# ---- the staged ELL plug-in and the grouped slab form --------------------

BLOCK_SMEM_OPTIN = 232448   # shared memory a block may opt in to (H100)


def _staged_smem_bytes(tile_bytes, l, s):
    """Shared memory a block of the staged ELL kernels takes at depth l for
    a slab of s columns (csrc/fused_iter.cuh), ``tile_bytes`` the plan's
    64-row tile.  One column (``fused_iter_kernel_staged``, 256 rows a
    block): the 256-row tile, then its static arrays (the index and scalar
    vectors, the store masks, the 8 warps' sums of the 2l+1 products, the
    barrier).  A slab (``fused_iter_kernel_slab_ell``): the tile, then for
    up to 8 columns the sums of its 2 warps, the scalar and index vectors
    and the store masks, and the barrier (static)."""
    setup = (8 + l) * 8 + (8 * l + 9) * 4 + 2 * l * 4
    if s == 1:
        return 4 * tile_bytes + setup + (2 * l + 1) * 8 * 8 + 8
    return tile_bytes + min(s, 8) * ((2 * l + 1) * 2 * 8 + setup) + 8


@pytest.mark.parametrize("s", [1, 2, 3, 8, 9])
@pytest.mark.parametrize("n,w", [(1, 11), (256, 11), (4097, 11),
                                 (1000, 12), (777, 21), (300, 22)])
def test_ell_tile_plan_covers_every_row_and_column_once(n, w, s):
    """The superkernel ELL plug-in's launch plan, walked in its kernel's
    order for aligned and misaligned bases: staged, one block an
    ELL_ROWS-row tile runs every column of the slab; direct, a (tiles, s)
    grid of BLOCK-row tiles.  Every
    (row, column) is covered once, each column's blocks are the s = 1
    launch's partition (so its partials come from the same blocks), a
    bulk-copied tile is full with 16-byte-aligned spans, a misaligned base
    sends every tile through ordinary loads, and a block's shared memory
    stays within the budget at every compile-time depth."""
    from repro_torch.kernels import fused_iter as tfi

    staged = tfi.ELL_ROWS * w * 12 <= tfi.ELL_TILE_BYTES
    assert staged == (w <= 21)
    B = tfi.ELL_ROWS if staged else tfi.BLOCK
    single = [(r0, min(B, n - r0)) for r0 in range(0, n, B)]
    for offsets in ((0, 0), (4, 8), (0, 8), (12, 0)):
        p = tfi.ell_tile_plan(n, w, *offsets)
        assert p.staged == staged
        assert p.tiles == len(single)
        seen = np.zeros((s, n), np.int64)
        blocks_of = [[] for _ in range(s)]
        grid = [(t, c) for t in range(p.tiles) for c in range(s)] \
            if not p.staged else [(t, None) for t in range(p.tiles)]
        for t, col in grid:
            r0, nr = t * B, min(B, n - t * B)
            for c in (range(s) if col is None else [col]):
                seen[c, r0:r0 + nr] += 1
                blocks_of[c].append((r0, nr))
            if t < p.bulk_tiles:
                assert nr == B
                for off, size in ((offsets[0], 4), (offsets[1], 8)):
                    assert (off + r0 * w * size) % tfi.BULK_ALIGN == 0
                    assert (nr * w * size) % tfi.BULK_ALIGN == 0
        assert (seen == 1).all()
        assert all(sorted(b) == single for b in blocks_of)
        aligned = offsets[0] % 16 == 0 and offsets[1] % 16 == 0
        if p.staged:
            assert p.tile_bytes == B * w * 12 <= tfi.ELL_TILE_BYTES
            assert p.bulk_tiles == (n // B if aligned else 0)
            for l in range(1, tfi.LMAX + 1):
                smem = _staged_smem_bytes(p.tile_bytes, l, s)
                assert B == tfi.ELL_ROWS
                static = (8 + l) * 8 + (8 * l + 9) * 4 + 2 * l * 4 + \
                    (2 * l + 1) * 8 * 8 + 8 if s == 1 else 8
                assert smem == tfi.staged_smem_bytes(l, w, s) + static
                assert smem <= BLOCK_SMEM_OPTIN
        else:
            assert p.bulk_tiles == 0 and p.tile_bytes == 0


SM_SMEM, BLOCK_RESERVED = 233472, 1024   # an H100 SM's shared memory, and
                                         # what the card keeps of it a block


@pytest.mark.parametrize("n,tiles,bulk", [(500_000, 7813, 7812),
                                          (125_000, 1954, 1953)])
def test_ell_tile_plan_at_the_ice_sheet_and_a_shard(n, tiles, bulk):
    """The staged ELL plan at ``icesheet3d``'s row counts (W = 11, aligned
    bases): the whole sheet and one shard of 4.  Its tiles (a column's
    partials), bulk-copied tiles and tile bytes, and a block's shared
    memory.  One column: a 256-row tile, so 4 blocks of 256 threads (64
    registers) fit an SM and a shard's rows are all resident at once.  A
    slab (8 columns' setup and warp sums at most): the 9 blocks of 64
    threads an SM that its registers allow fit its shared memory too, and
    a shard's tiles are more than 1.5 times those places."""
    from repro_torch.kernels import fused_iter as tfi

    p = tfi.ell_tile_plan(n, 11, 0, 0)
    assert (p.staged, p.tiles, p.bulk_tiles, p.tile_bytes) == \
        (True, tiles, bulk, 64 * 11 * 12)
    assert tfi.staged_smem_bytes(2, 11, 1) == 256 * 11 * 12 == 33792
    column = 5 * 2 * 8 + (8 + 2) * 8 + (8 * 2 + 9) * 4 + 2 * 2 * 4
    assert tfi.staged_smem_bytes(2, 11, 8) == 8448 + 8 * column == 10656
    assert tfi.staged_smem_bytes(2, 11, 32) == tfi.staged_smem_bytes(2, 11, 8)
    one = _staged_smem_bytes(p.tile_bytes, 2, 1)
    assert 4 * (one + BLOCK_RESERVED) <= SM_SMEM
    assert (4 * 256 * 132 >= n) == (n == 125_000)
    for s in (8, 32):
        smem = _staged_smem_bytes(p.tile_bytes, 2, s)
        assert 9 * (smem + BLOCK_RESERVED) <= SM_SMEM
    assert p.tiles >= 1.5 * 9 * 132


@pytest.mark.parametrize("s", [1, 2, 3, 8, 9, 32])
@pytest.mark.parametrize("rows,w", [(4097, 11), (512, 12), (100, 400)])
def test_ell_slab_groups_cover_every_row_and_vector_once(rows, w, s):
    """``ell_spmv``'s slab launch, walked in its kernel's order: the plan's
    tiles (or the direct kernel's blocks) over the rows, and in each row
    the vectors in groups of ``slab_group(s)`` from the first, the last
    holding the rest.  Every (row, vector) is summed once, the group is a
    power of two no wider than ``SLAB_GROUP`` and wastes less than one
    group's lanes, a slab's ring has ``SLAB_STAGES`` stages over the
    single vector's tiles, and a single vector keeps the single-vector
    kernel and its ring."""
    sms, per_sm = 132, 3
    g = tel.slab_group(s)
    assert g & (g - 1) == 0 and min(s, tel.SLAB_GROUP) <= g <= tel.SLAB_GROUP
    assert (g == 1) == (s == 1)
    stages = tel.STAGES if g == 1 else tel.SLAB_STAGES
    p = tel.plan(rows, w, 8, 0, 0, sms, lambda threads, smem: per_sm, stages)
    one = tel.plan(rows, w, 8, 0, 0, sms, lambda threads, smem: per_sm)
    assert (p.staged, p.tile_rows, p.tiles, p.bulk_tiles) == \
        (one.staged, one.tile_rows, one.tiles, one.bulk_tiles)
    if p.staged:
        assert p.stages == stages
        assert p.smem_bytes == stages * p.tile_rows * w * 12
    seen = np.zeros((s, rows), np.int64)
    lanes = 0
    for blk in range(p.grid):
        tiles = range(blk, p.tiles, p.grid) if p.staged else [blk]
        for t in tiles:
            r0 = t * p.tile_rows
            nr = min(p.tile_rows, rows - r0)
            for k0 in range(0, s, g):
                ng = min(g, s - k0)
                seen[k0:k0 + ng, r0:r0 + nr] += 1
                lanes += g * nr
    assert (seen == 1).all()
    assert lanes - s * rows < g * rows


def _slab_triples(layout, n, s, rng, dev):
    """A slab of s columns, each at its own cycle index (pipeline fill and
    steady state), with random rows and scalars."""
    from repro_torch.kernels import fused_iter as tfi

    l = layout.l
    IS = tfi.scal_layout(l)
    hosts = [tfi.host_idx(layout, i) for i in
             [2 * l + 3 + c for c in range(s - 1)] + [l - 1]][:s]
    scal = rng.standard_normal((s, IS["size"]))
    scal[:, IS["dlt_safe"]] = 1.25
    scal[:, IS["eta_new_safe"]] = 0.75
    scal[:, IS["eta0_safe"]] = 1.5
    return convert.vector_phase(rng.standard_normal((s, layout.nv, n)),
                                hosts, scal, dev)


def _ell_slab_cases(rng, dev):
    """The ice-sheet stand-in (W = 11, a ragged last tile), the same arrays
    one element off the 16-byte grid (every tile by ordinary loads), an
    even W over an exact tile count, and a W too wide to stage."""
    op = tsp.rcm_reorder(tsp.random_fem_icesheet(48, 10, 6, 4,
                                                 device=dev))[0]

    def offset_copy(t, off):
        buf = torch.zeros(t.numel() + off, dtype=t.dtype, device=dev)
        buf[off:] = t.reshape(-1)
        return buf[off:].view(t.shape)

    yield "icesheet", op.cols, op.vals
    yield "misaligned", offset_copy(op.cols, 1), offset_copy(op.vals, 1)
    yield "w12", *_ell_case(rng, 1024, 12, 1024, dev)
    yield "w22_direct", *_ell_case(rng, 700, 22, 700, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 2, 3, 8, 9])
def test_slab_ell_superkernel_bitwise_on_card(cuda_device, l):
    """The ELL superkernel's slab form at s in {1, 2, 3, 8, 9}: every row
    bitwise the plain version's and every column's rows and partials
    bitwise those of its single-column launch (partials within 1e-12 of
    the plain sums, which take another order)."""
    from repro_torch.kernels import fused_iter as tfi

    rng = np.random.default_rng(23 + l)
    for name, cols, vals in _ell_slab_cases(rng, cuda_device):
        n = cols.shape[0]
        inv = torch.tensor(rng.uniform(0.5, 2.0, n), device=cuda_device)
        layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3))
        fiter = tfi.build_fused_iteration(layout, tfi.ell_spmv(cols, vals),
                                          inv)
        for s in (1, 2, 3, 8, 9):
            S, idx, sc = _slab_triples(layout, n, s, rng, cuda_device)
            S_p, d_p = fiter.plain(S, idx, sc)
            key = tfi.launch_key("ell", l, slab=True)
            before = _launches(key)
            S_k, d_k = fiter(S.clone(), idx, sc)
            assert _launches(key) == before + 1
            assert torch.equal(S_k, S_p), (name, s)
            torch.testing.assert_close(d_k, d_p, rtol=1e-12, atol=1e-12)
            for c in range(s):
                S_1, d_1 = fiter(S[c].clone(), idx[c], sc[c])
                assert torch.equal(S_1, S_k[c]), (name, s, c)
                assert torch.equal(d_1, d_k[c]), (name, s, c)


@pytest.mark.cuda
def test_ell_spmv_slab_bitwise_on_card(cuda_device):
    """``ell_spmv``'s slab form on the same operators at s in
    {1, 2, 3, 8, 9, 32}, fp64 and fp32: bitwise ``ell_spmv_plain`` and,
    row by row, the single-vector launch."""
    rng = np.random.default_rng(31)
    for name, cols, vals in list(_ell_slab_cases(rng, cuda_device)) + [
            ("w400_direct", *_ell_case(rng, 100, 400, 100, cuda_device))]:
        n = cols.shape[0]
        for s in (1, 2, 3, 8, 9, 32):
            X = torch.tensor(rng.standard_normal((s, n + 13)),
                             device=cuda_device)
            for dt in (torch.float64, torch.float32):
                v = vals.to(dt) if dt != vals.dtype else vals
                before = _launches("ell_spmv_slab")
                got = tel.ell_spmv(X, cols, v)
                assert _launches("ell_spmv_slab") == before + 1
                assert torch.equal(got, tel.ell_spmv_plain(X, cols, v)), (
                    name, s, dt)
                for c in range(s):
                    assert torch.equal(got[c], tel.ell_spmv(X[c], cols, v))


# --------------------------------------------------------- sliced ELL ----
# The three sliced-ELL tests of tests/test_sparse.py, each held against
# the JAX package's function: the construction is the same host numpy, so
# permutations, slice arrays, nnz and occupancy agree exactly; ``apply``
# within the ELL tolerance above.

def _same_slices(jsl, tsl):
    assert len(jsl.slice_cols) == len(tsl.slice_cols)
    for jc, jv, tc, tv in zip(jsl.slice_cols, jsl.slice_vals,
                              tsl.slice_cols, tsl.slice_vals):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tsl.n, tsl.nnz, tsl.padded_slots) == (jsl.n, jsl.nnz,
                                                  jsl.padded_slots)
    assert tsl.occupancy() == jsl.occupancy()


def test_sliced_ell_matches_dense(with_jax):
    """The sliced operator reproduces P A P^T exactly, the composed
    permutation is a valid reordering, and both are the JAX package's."""
    op = tsp.random_fem_mesh(4, 300, device="cpu")
    sliced, perm = tsp.sliced_ell_reorder(op, slice_rows=32)
    jsliced, jperm = jsp.sliced_ell_reorder(jsp.random_fem_mesh(4, 300),
                                            slice_rows=32)
    np.testing.assert_array_equal(perm, jperm)
    _same_slices(jsliced, sliced)
    assert sorted(perm.tolist()) == list(range(op.n))
    a = op.to_dense()
    np.testing.assert_allclose(sliced.to_dense(), a[np.ix_(perm, perm)],
                               atol=1e-12)
    np.testing.assert_array_equal(sliced.to_dense(), jsliced.to_dense())
    x = np.random.default_rng(12).standard_normal(op.n)
    inv = np.argsort(perm)
    y = sliced.apply(torch.as_tensor(x[perm])).numpy()[inv]
    np.testing.assert_allclose(y, op.apply(torch.as_tensor(x)).numpy(),
                               atol=1e-11)
    yj = np.asarray(jsliced.apply(jnp.asarray(x[perm])))
    scale = np.abs(sliced.to_dense()) @ np.abs(x[perm])
    np.testing.assert_array_less(np.abs(sliced.apply(torch.as_tensor(
        x[perm])).numpy() - yj), RTOL * scale + 1e-300)
    np.testing.assert_array_equal(sliced.diag().numpy(),
                                  np.asarray(jsliced.diag()))


def test_sliced_ell_occupancy_improves(with_jax):
    """On the FEM problem class slot occupancy rises from ~0.58 to >= 0.85,
    with nnz conserved, waste = 1 - occupancy and non-increasing slice
    widths, as in the JAX package."""
    op = tsp.random_fem_mesh(0, 1024, device="cpu")
    uniform_occ = op.nnz / (op.n * op.w)
    sliced, perm = tsp.sliced_ell_reorder(op, slice_rows=64)
    jsliced, jperm = jsp.sliced_ell_reorder(jsp.random_fem_mesh(0, 1024),
                                            slice_rows=64)
    np.testing.assert_array_equal(perm, jperm)
    _same_slices(jsliced, sliced)
    assert sliced.nnz == op.nnz
    assert sliced.occupancy() >= max(0.85, uniform_occ)
    assert abs(sliced.padding_waste() - (1 - sliced.occupancy())) < 1e-12
    widths = [c.shape[1] for c in sliced.slice_cols]
    assert widths == sorted(widths, reverse=True)
    # Degree sorting makes every width group a run of rows: no permutation
    # after the groups' outputs.
    assert len(sliced.groups) == len(set(widths))
    assert sliced.rows_out is None


def test_sliced_ell_respects_preordering(with_jax):
    """An RCM-ordered operator keeps its ordering as the base of the
    composition (no second RCM pass)."""
    op, _ = tsp.rcm_reorder(tsp.random_fem_mesh(2, 200, device="cpu"))
    sliced, perm = tsp.sliced_ell_reorder(op, slice_rows=25)
    np.testing.assert_array_equal(perm, tsp.degree_sort_permutation(op))
    jop, _ = jsp.rcm_reorder(jsp.random_fem_mesh(2, 200))
    _, jperm = jsp.sliced_ell_reorder(jop, slice_rows=25)
    np.testing.assert_array_equal(perm, jperm)
    assert sliced.n == op.n


def _per_slice(sliced, x):
    """The JAX package's apply: one gather and rowsum a slice."""
    return torch.cat([tref.ell_rowsum(v.to(x.dtype), x[..., c])
                      for c, v in zip(sliced.slice_cols, sliced.slice_vals)],
                     dim=-1)


def test_sliced_apply_by_width_groups_bitwise():
    """The width-grouped apply is bitwise the per-slice loop, for one
    vector and a slab, in row order and with interleaved widths (the
    output permutation); its solve is bitwise that of the permuted
    padded-ELL operator (a padded slot adds an exact zero); the fused path
    refuses it, as in the JAX package."""
    rng = np.random.default_rng(21)
    op = tsp.random_fem_icesheet(48, 10, 6, 4, device="cpu")
    sliced, perm = tsp.sliced_ell_reorder(op, slice_rows=16)
    order = [2, 0, 5, 1] + list(range(6, len(sliced.slice_cols))) + [3, 4]
    mixed = tsp.SlicedEllOp(
        slice_rows=16, slice_cols=tuple(sliced.slice_cols[s] for s in order),
        slice_vals=tuple(sliced.slice_vals[s] for s in order), device="cpu")
    assert sliced.rows_out is None and mixed.rows_out is not None
    for sl in (sliced, mixed):
        for x in (torch.tensor(rng.standard_normal(op.n)),
                  torch.tensor(rng.standard_normal((3, op.n)))):
            assert torch.equal(sl.apply(x), _per_slice(sl, x))
        np.testing.assert_array_equal(sl.diag().numpy(),
                                      np.diag(sl.to_dense()))
    base = tsp.rcm_reorder(op)[0]
    pop = tsp.permute_spd(base, tsp.degree_sort_permutation(base))
    b = torch.tensor(rng.standard_normal(op.n))
    kw = dict(l=2, tol=1e-8, maxit=300)
    runs = [tpc.solve(SolverOps.local(o, JacobiPrec.from_operator(o)), b,
                      **kw) for o in (sliced, pop)]
    assert bool(runs[0].converged) and int(runs[0].iters) > 0
    assert torch.equal(runs[0].res_history, runs[1].res_history)
    assert torch.equal(runs[0].x, runs[1].x)
    with pytest.raises(ValueError, match="fused_iter_factory"):
        tpc.solve(SolverOps.local(sliced, JacobiPrec.from_operator(sliced)),
                  b, 2, fused_iteration=True)


@pytest.mark.cuda
def test_sliced_apply_on_card(cuda_device):
    """The sliced apply on the card equals its CPU result within the ELL
    tolerance (per row 1e-13 of sum |A||x|), for one vector and a slab."""
    op = tsp.random_fem_icesheet(48, 10, 6, 4, device="cpu")
    sliced, _ = tsp.sliced_ell_reorder(op, slice_rows=64)
    card = tsp.SlicedEllOp(sliced.slice_rows, sliced.slice_cols,
                           sliced.slice_vals, device=cuda_device)
    rng = np.random.default_rng(8)
    for shape in ((op.n,), (4, op.n)):
        x = torch.tensor(rng.standard_normal(shape))
        scale = x.abs() @ torch.as_tensor(np.abs(sliced.to_dense())).T
        diff = (card.apply(x.to(cuda_device)).cpu() - sliced.apply(x)).abs()
        assert bool((diff <= RTOL * scale + 1e-300).all())
