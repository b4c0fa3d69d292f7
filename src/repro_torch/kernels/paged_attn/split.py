"""The split-KV schedule of the two decode kernels (``paged_decode.cu`` and
``../decode_attn/csrc/decode_attn.cu``, both on ``csrc/decode_split.cuh``).

A call runs ``splits`` CTAs, one thread-block cluster, per (slot, KV head,
group of at most ``CTA_ROWS`` of the G query heads that share the KV
head).  Rank ``r`` of a cluster walks the keys ``split_range(r, splits,
n_keys)`` of its slot, and the cluster merges the ranks' softmax states
through distributed shared memory in the same launch.  ``split_count``
picks ``splits`` from numbers the host knows without a device sync: the
batch, the KV heads, G, the key bound of the call (the table's width in
keys for the paged kernel, ``s_cap`` for the dense one) and the card's SM
count (:func:`repro_torch.device.sm_count`).  The kernels compute each
rank's range on the device from ``lengths[b]`` (``rank_range`` in
``decode_split.cuh``); no op runs :func:`split_range` or
:func:`boundary_lengths`, which the checks use as the host's mirror of
that schedule.
"""
from __future__ import annotations

TILE = 16          # keys; every range starts on a multiple (kTile)
MAX_SPLITS = 8     # the portable cluster size (kMaxSplits)
CTA_ROWS = 2       # query rows a CTA keeps (kCtaRows)


def row_groups(group: int) -> int:
    """CTAs that share the ``group`` query heads of one KV head."""
    return -(-max(int(group), 1) // CTA_ROWS)


def split_count(batch: int, hkv: int, group: int, key_bound: int,
                sms: int) -> int:
    """Ranks per (slot, KV head, row group): the least power of two from 1
    to ``MAX_SPLITS`` that gives two CTAs in all for each of the card's
    ``sms`` SMs, but never more ranks than the key bound has tiles.
    ``group`` is G, the query heads per KV head."""
    tiles = -(-max(int(key_bound), 0) // TILE)
    ctas = batch * hkv * row_groups(group)
    s = 1
    while s < MAX_SPLITS and ctas * s < 2 * sms and 2 * s <= tiles:
        s *= 2
    return s


def _per_rank(splits: int, n_keys: int) -> int:
    """Keys a rank takes from a slot of ``n_keys`` keys (the last live
    rank may take fewer)."""
    tiles = -(-n_keys // TILE)
    return -(-tiles // splits) * TILE


def split_range(rank: int, splits: int, n_keys: int) -> tuple[int, int]:
    """Keys ``[lo, hi)`` of rank ``rank`` of ``splits`` over a slot with
    ``n_keys`` live keys: the slot's tiles shared out evenly, ranks in
    order, so every range starts on a tile and a rank past the slot's
    last tile gets ``lo == hi == n_keys``.  A check fixture: the kernels
    compute the same ranges on the device."""
    n_keys = max(int(n_keys), 0)
    lo = min(rank * _per_rank(splits, n_keys), n_keys)
    return lo, min(lo + _per_rank(splits, n_keys), n_keys)


def boundary_lengths(splits: int, key_bound: int) -> list[int]:
    """Slot lengths from 0 to ``key_bound`` that end one key before, at or
    one key past the end of a rank's range, for each rank and for ranges
    of one to three tiles: where a split walk can miss or repeat a key.
    A check fixture: the checks of the decode kernels use them."""
    out = set()
    for tiles in (1, 2, 3):
        per = tiles * TILE
        for rank in range(1, splits + 1):
            for n in (rank * per - 1, rank * per, rank * per + 1):
                if 0 <= n <= key_bound and _per_rank(splits, n) == per:
                    out.add(n)
    return sorted(out)
