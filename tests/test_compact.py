"""count_sort.compact_marked (block-local sorts + scan stitch) against a
numpy oracle: the marked rows of a sorted run view, in order, at fixed
capacity, with the overflow counted."""

import numpy as np
import pytest

ONES = 0xFFFFFFFF


def _run_view(rng, W, N, dtype=np.int32):
    """A sorted W-lane run view as count_presentineled returns it: live
    rows ascending with duplicates, a sentinel tail, tail-marked runs."""
    n_live = N - N // 8
    live = rng.integers(0, 64, size=(n_live, W), dtype=np.uint32)
    live = live[np.lexsort(live.T[::-1])]
    rows = np.concatenate([live, np.full((N - n_live, W), ONES, np.uint32)])
    tail = np.ones(N, bool)
    tail[:-1] = np.any(rows[1:] != rows[:-1], axis=1)
    tail[n_live:] = False
    counts = rng.integers(1, 1000, size=N).astype(dtype)
    return rows, counts, tail


def _oracle(rows, counts, marked, out_cap):
    sel = np.flatnonzero(marked)
    n_u = sel.size
    keep = sel[:out_cap]
    W = rows.shape[1]
    out = np.full((out_cap, W), ONES, np.uint32)
    out[: keep.size] = rows[keep]
    cnt = np.zeros(out_cap, counts.dtype)
    cnt[: keep.size] = counts[keep]
    return out, cnt, n_u, max(n_u - out_cap, 0)


def _compact(rows, counts, marked, out_cap, block):
    import jax
    import jax.numpy as jnp

    from fastkmer_tpu.ops import count_sort

    fn = jax.jit(
        lambda c, n, u: count_sort.compact_marked(c, n, u, out_cap, block=block)
    )
    cols = tuple(jnp.asarray(rows[:, w]) for w in range(rows.shape[1]))
    ccols, cnt, n_u, over = fn(cols, jnp.asarray(counts), jnp.asarray(marked))
    return (np.stack([np.asarray(c) for c in ccols], 1), np.asarray(cnt),
            int(n_u), int(over))


@pytest.mark.parametrize(
    "W,block,N,out_cap",
    [(1, 1024, 2048, 4096), (2, 1024, 4096, 512), (2, 2048, 2048, 1024),
     (3, 1024, 1024, 128)],
)
def test_compact_marked_matches_numpy(W, block, N, out_cap):
    rng = np.random.default_rng(W * 1000 + N)
    rows, counts, marked = _run_view(rng, W, N)
    got = _compact(rows, counts, marked, out_cap, block)
    want = _oracle(rows, counts, marked, out_cap)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2:] == want[2:]


def test_compact_marked_keeps_int32_counts():
    """Run totals stay int32 end to end, up to the largest int32 value."""
    rng = np.random.default_rng(5)
    rows, counts, marked = _run_view(rng, 2, 2048)
    counts[np.flatnonzero(marked)[:3]] = np.iinfo(np.int32).max
    got = _compact(rows, counts, marked, 1024, 1024)
    want = _oracle(rows, counts, marked, 1024)
    assert got[1].dtype == np.int32
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])
