"""The port's copy of the block-pool allocator against the JAX package's:
the same random admit / share / extend / release / hold traffic (numpy,
fixed seeds) drives both, and after every operation their full snapshots
(free list, partitions, tables, refcounts) are identical and ``check()``
holds.  Plus the allocator's unit invariants on the port's copy."""
import numpy as np
import pytest
import torch

from repro.serve.kvpool import KVPool as JaxKVPool
from repro.serve.kvpool import PageError as JaxPageError
from repro_torch.serve.kvpool import KVPool, PageError

torch.set_num_threads(1)


def _step(pool, op, args):
    try:
        return ("ok", getattr(pool, op)(*args))
    except (PageError, JaxPageError) as err:
        return ("error", type(err).__name__)


@pytest.mark.parametrize("seed", range(8))
def test_random_traffic_matches_jax_allocator(seed):
    rng = np.random.default_rng(seed)
    n_pages, ps, slots = int(rng.integers(4, 24)), int(rng.integers(1, 8)), \
        int(rng.integers(2, 6))
    mine, ref = KVPool(n_pages, ps, slots), JaxKVPool(n_pages, ps, slots)
    for _ in range(60):
        slot = int(rng.integers(slots))
        kind = rng.choice(["reserve", "release", "share", "extend", "hold",
                           "release_held"])
        if kind == "reserve":
            args = (slot, int(rng.integers(0, n_pages * ps + 2)))
        elif kind == "release":
            cacheable = frozenset(rng.choice(n_pages, size=2).tolist())
            args = (slot, cacheable, bool(rng.integers(2)))
        elif kind == "share":
            donor = int(rng.integers(slots))
            pages = ref.slot_pages(donor)
            args = (slot, pages[:int(rng.integers(0, len(pages) + 1))])
        elif kind == "extend":
            args = (slot, int(rng.integers(0, 3)))
        elif kind == "hold":
            args = (int(rng.integers(0, 3)),)
        else:
            args = ()
        assert _step(mine, kind, args) == _step(ref, kind, args), kind
        assert mine.snapshot() == ref.snapshot()
        mine.check()
        assert mine.can_admit(5) == ref.can_admit(5)
        assert mine.pressure() == ref.pressure()


def test_reserve_release_roundtrip():
    pool = KVPool(n_pages=8, page_size=4, slots=2)
    pages = pool.reserve(0, 10)          # ceil(10/4) = 3 pages
    assert len(pages) == 3 and pool.free_pages == 5
    assert list(pool.table[0, :3]) == pages
    assert (pool.table[0, 3:] == pool.sentinel).all()
    assert pool.sentinel == pool.n_pages
    pool.check()
    assert pool.release(0) == 3
    assert pool.free_pages == 8
    assert (pool.table[0] == pool.sentinel).all()
    pool.check()


def test_exhaustion_and_admission():
    pool = KVPool(n_pages=4, page_size=2, slots=4)
    assert pool.can_admit(8) and not pool.can_admit(9)
    pool.reserve(0, 6)
    assert pool.can_admit(2) and not pool.can_admit(3)
    with pytest.raises(PageError):
        pool.reserve(1, 4)
    pool.check()


def test_double_free_and_double_reserve_rejected():
    pool = KVPool(n_pages=4, page_size=2, slots=2)
    pool.reserve(0, 2)
    with pytest.raises(PageError, match="already holds"):
        pool.reserve(0, 2)
    with pytest.raises(PageError, match="zero-token"):
        pool.reserve(1, 0)
    pool.refcount[pool.slot_pages(0)[0]] = 0
    with pytest.raises(PageError, match="double free"):
        pool.release(0)


def test_check_catches_refcount_drift():
    pool = KVPool(n_pages=6, page_size=2, slots=2)
    pool.reserve(0, 4)
    pool.check()
    pool.refcount[pool.slot_pages(0)[0]] += 1
    with pytest.raises(PageError):
        pool.check()


def test_max_pages_bounds_one_slot():
    pool = KVPool(n_pages=10, page_size=2, slots=2, max_pages=3)
    assert not pool.can_admit(7)
    with pytest.raises(PageError, match="max_pages"):
        pool.reserve(0, 7)
    pool.reserve(0, 6)
    assert pool.table.shape == (2, 3)
    pool.check()
