"""B' (``bwd_reduce_kernel``, ``csrc/trace_wave_bwd.cu``): the fixed-order
row sums, on the CPU.

``ops/uber.bwd_reduce_replay`` replays the kernel's order of operations
(pieces of 1024 sorted terms, 4 consecutive terms a thread, a segmented
scan in each warp, the warps' carries in order, a run that crosses pieces
as partials added in piece order); on the card the kernel equals it bit for
bit (``tests/test_torch_gpu.py::test_row_sums_on_card``,
``test_bwd_reduce_atlas_on_card``). Here the replay is held against a
float64 ``index_add_`` within 1e-5 of the sum of each row's term
magnitudes (``chip_smoke.row_sums_vs_float64``'s budget: a term is rounded
at most ~120 times, 4 in its thread, 5 scan steps, 8 warps and the
pieces of its run, at float32's 6e-8), against the CPU's float32
``index_add_`` exactly where a run lies inside one thread (both add from 0
in the terms' order), and against ``bwd_reduce_plain`` (``index_add_`` of
the same sorted terms) within the same budget. Every row no term names is
exactly zero.
"""

import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu_torch.kernels import reduce_order
from rust_ray_tracer_tpu_torch.ops import uber
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

BUDGET = 1e-5


def _terms(keys, w, seed=0):
    """(contrib [m, w] float32 normal draws, keys [m] int32) from numpy."""
    r = np.random.default_rng(seed)
    keys = np.asarray(keys, dtype=np.int32)
    contrib = r.normal(size=(keys.size, w)).astype(np.float32)
    return torch.from_numpy(contrib), torch.from_numpy(keys)


def _part(seed=1, blocks=37, ltn=28):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=(blocks, ltn)).astype(np.float32))


def _check(contrib, keys, p_rows, part=None):
    """The replay's (duni, dlt) on these terms, after holding it against
    float64, ``bwd_reduce_plain`` and zero rows."""
    part = _part() if part is None else part
    skeys, perm = reduce_order(keys)
    got = uber.bwd_reduce_replay(contrib, skeys, perm, p_rows, part)
    plain = uber.bwd_reduce_plain(contrib, skeys, perm, p_rows, part)
    found = keys < p_rows
    idx = keys[found].long()
    c64 = contrib.reshape(-1, contrib.shape[-1])[found].double()
    ref = torch.zeros((p_rows, c64.shape[1]), dtype=torch.float64)
    ref.index_add_(0, idx, c64)
    mag = torch.zeros_like(ref).index_add_(0, idx, c64.abs())
    assert got[0].shape == (p_rows, c64.shape[1])
    assert bool(((got[0].double() - ref).abs() <= BUDGET * mag).all())
    assert bool(((plain[0].double() - ref).abs() <= BUDGET * mag).all())
    assert bool((got[0][mag == 0] == 0).all())
    p64 = part.double().sum(0)
    assert bool(((got[1].double() - p64).abs()
                 <= BUDGET * part.double().abs().sum(0)).all())
    return got


@pytest.mark.parametrize("w", [1, 3, 17, 32])
def test_runs_of_one_term_equal_index_add(w):
    """Every row named once (a permutation of the rows, the last row
    p_rows - 1 among them): each sum is its one term, 0 + x, exactly as
    ``index_add_`` into zeros gives it."""
    p_rows = 3000
    keys = np.random.default_rng(2).permutation(p_rows)
    contrib, k = _terms(keys, w)
    got = _check(contrib, k, p_rows)[0]
    ref = torch.zeros((p_rows, w)).index_add_(0, k.long(), contrib)
    assert torch.equal(got, ref)
    assert torch.equal(got[p_rows - 1], contrib[int(np.argmax(keys))])


def test_short_runs_inside_a_thread_equal_index_add():
    """Runs of 2-4 terms that start on a thread's first term (the keys
    0, 0, 1, 1, 2, 2, 2, 2, ...): the kernel's thread adds them from 0 in
    the terms' order, as ``index_add_`` does, so the sums are equal bit for
    bit."""
    keys = np.repeat(np.arange(1500), np.tile([2, 2, 4], 500))
    contrib, k = _terms(keys, 3, seed=4)
    got = _check(contrib, k, 1500)[0]
    ref = torch.zeros((1500, 3)).index_add_(0, k.long(), contrib)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("sizes", [
    [1023, 2],                       # across one piece boundary
    [700, 2000, 5, 3000, 1],         # across one and several
    [100_000, 37, 5000, 1],          # a lamp row: ~98 pieces
])
def test_runs_crossing_pieces(sizes):
    """Runs that cross one and many 1024-term pieces, in shuffled term
    order (the stable sort gathers them), with keys out of the table
    (>= p_rows, a ray that found no row) after them: the float64
    budget."""
    p_rows = len(sizes)
    keys = np.concatenate([np.full(n, r) for r, n in enumerate(sizes)]
                          + [np.full(900, p_rows)])
    keys = np.random.default_rng(5).permutation(keys)
    contrib, k = _terms(keys, 3, seed=6)
    got = _check(contrib, k, p_rows)[0]
    assert bool((got.abs().sum(1) > 0).all())


def test_atlas_table_few_rows_with_terms():
    """A 524,288-row table (the earth map's atlas) whose 147,456 terms go
    to ~80 rows, most to one (a wave's lanes off the map): the other
    524,208 rows exactly zero, the named ones within the budget."""
    r = np.random.default_rng(7)
    rows = r.choice(524_288, size=80, replace=False)
    keys = rows[np.minimum(r.geometric(0.05, size=147_456) - 1, 79)]
    contrib, k = _terms(keys, 3, seed=8)
    got = _check(contrib, k, 524_288)[0]
    named = torch.zeros(524_288, dtype=torch.bool)
    named[torch.from_numpy(rows)] = True
    assert bool((got[~named] == 0).all())
    assert int((got[named].abs().sum(1) > 0).sum()) == 80


def test_no_terms_and_light_table_alone():
    """m = 0 (the light-table sum of a backward kernel's partials alone):
    duni is P zero rows, dlt the partials' sums in the kernel's order;
    ``part`` [0, 0] (a row sum with no light table) gives an empty dlt."""
    contrib = torch.zeros((0, 1))
    none = torch.zeros((0,), dtype=torch.int32)
    part = _part(blocks=1152, ltn=42)
    duni, dlt = uber.bwd_reduce_replay(contrib, none, none, 5, part)
    assert torch.equal(duni, torch.zeros((5, 1)))
    assert bool(((dlt.double() - part.double().sum(0)).abs()
                 <= BUDGET * part.double().abs().sum(0)).all())
    contrib, k = _terms([4, 4, 0], 2)
    skeys, perm = reduce_order(k)
    _, dlt = uber.bwd_reduce_replay(contrib, skeys, perm, 5,
                                    torch.zeros((0, 0)))
    assert dlt.shape == (0,)


def test_replay_repeats_bitwise_and_ignores_term_order_within_keys():
    """Two replays of the same terms give the same bits, and B''s wrappers'
    input (``reduce_order``'s stable sort) fixes the order of a row's
    terms by their positions, so a [depth, N] key array gives the sums of
    its flattened form."""
    r = np.random.default_rng(9)
    keys = r.integers(0, 600, size=(4, 9216))
    keys[r.random(keys.shape) < 0.3] = 600          # no row found
    contrib, k = _terms(keys.reshape(-1), 5, seed=10)
    a = _check(contrib, k, 600)
    skeys, perm = reduce_order(k.reshape(4, 9216))
    b = uber.bwd_reduce_replay(contrib.reshape(4, 9216, 5), skeys, perm,
                               600, _part())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
