"""Data pipeline tests: TSV parsing, sharding, resumable cursor, synthetic
signal learnability."""

import numpy as np
import jax.numpy as jnp

from recmodels.data import CriteoTSVSource, SyntheticSource, criteo_schema
from recmodels.data.criteo import parse_criteo_lines, transform_dense

SCH = criteo_schema(vocab_size=1000, embed_dim=8)


def _write_tsv(tmp_path, n=100, seed=0):
    rng = np.random.default_rng(seed)
    path = tmp_path / "sample.tsv"
    with open(path, "wb") as f:
        for i in range(n):
            label = rng.integers(0, 2)
            dense = [
                b"" if rng.random() < 0.2 else str(rng.integers(0, 1000)).encode()
                for _ in range(13)
            ]
            cats = [
                b"" if rng.random() < 0.1 else format(rng.integers(0, 2**32), "08x").encode()
                for _ in range(26)
            ]
            f.write(b"\t".join([str(label).encode(), *dense, *cats]) + b"\n")
    return str(path)


def test_parse_criteo_lines_shapes():
    line = b"1\t" + b"\t".join(str(i).encode() for i in range(13)) + b"\t" + b"\t".join(
        [format(i, "08x").encode() for i in range(26)]
    )
    b = parse_criteo_lines([line, b"0\t\t" + b"\t" * 37], SCH)
    assert b.dense.shape == (2, 13) and b.ids.shape == (2, 26) and b.labels.tolist() == [1.0, 0.0]
    assert b.ids[1].tolist() == [0] * 26  # all missing -> bucket 0
    np.testing.assert_allclose(b.dense[0, 2], np.log1p(2.0))


def test_transform_dense_handles_negatives_and_nan():
    x = np.array([[np.nan, -5.0, 3.0]], np.float32)
    out = transform_dense(x)
    np.testing.assert_allclose(out, [[0.0, 0.0, np.log1p(3.0)]])


def test_tsv_source_sharding_partitions_rows(tmp_path):
    path = _write_tsv(tmp_path, n=64)
    full = [b for b in CriteoTSVSource(path, SCH, batch_size=64)]
    s0 = [b for b in CriteoTSVSource(path, SCH, batch_size=32, shard_index=0, shard_count=2)]
    s1 = [b for b in CriteoTSVSource(path, SCH, batch_size=32, shard_index=1, shard_count=2)]
    assert full[0].size == 64
    got = np.concatenate([s0[0].labels, s1[0].labels])
    assert sorted(got.tolist()) == sorted(full[0].labels.tolist())


def test_tsv_source_resume_cursor(tmp_path):
    path = _write_tsv(tmp_path, n=60)
    src = CriteoTSVSource(path, SCH, batch_size=10)
    it = iter(src)
    b1 = next(it)
    b2 = next(it)
    state = src.state()
    b3 = next(it)
    # new source, restored cursor -> must produce b3 again
    src2 = CriteoTSVSource(path, SCH, batch_size=10)
    src2.set_state(state)
    b3b = next(iter(src2))
    np.testing.assert_array_equal(b3.ids, b3b.ids)
    np.testing.assert_array_equal(b3.labels, b3b.labels)


def test_synthetic_source_deterministic_and_resumable():
    s1 = SyntheticSource(SCH, batch_size=32, seed=5)
    it1 = iter(s1)
    a = next(it1)
    b = next(it1)
    state = s1.state()
    c = next(it1)
    s2 = SyntheticSource(SCH, batch_size=32, seed=5)
    s2.set_state(state)
    c2 = next(iter(s2))
    np.testing.assert_array_equal(c.ids, c2.ids)
    np.testing.assert_array_equal(c.labels, c2.labels)
    assert not np.array_equal(a.ids, b.ids)


def test_synthetic_shards_differ():
    a = next(iter(SyntheticSource(SCH, batch_size=32, seed=5, shard_index=0, shard_count=2)))
    b = next(iter(SyntheticSource(SCH, batch_size=32, seed=5, shard_index=1, shard_count=2)))
    assert not np.array_equal(a.ids, b.ids)


def test_synthetic_signal_is_learnable():
    """Labels must correlate with the planted logit (AUC of oracle > 0.7)."""
    from recmodels.train.metrics import auc_compute, auc_init, auc_update

    src = SyntheticSource(SCH, batch_size=4096, seed=9)
    batch = next(iter(src))
    # oracle score: rebuild the planted logit
    bw = src._bucket_weight(batch.ids)
    logit = batch.dense @ src._dense_w + bw.sum(1) * 0.5
    emb = bw[:, :, None] * src._slot_proj[None, :, :]
    s = emb.sum(axis=1)
    logit += 0.5 * ((s * s).sum(1) - (emb * emb).sum((1, 2))) * 0.15
    state = auc_update(auc_init(), jnp.asarray(logit.astype(np.float32)), jnp.asarray(batch.labels))
    assert float(auc_compute(state)["auc"]) > 0.7


def test_tsv_shuffle_deterministic_and_resumable(tmp_path):
    path = _write_tsv(tmp_path, n=100, seed=4)
    kw = dict(batch_size=10, shuffle_buffer=32, seed=7)
    a = CriteoTSVSource(path, SCH, **kw)
    b = CriteoTSVSource(path, SCH, **kw)
    ita, itb = iter(a), iter(b)
    for _ in range(3):
        ba, bb = next(ita), next(itb)
        np.testing.assert_array_equal(ba.ids, bb.ids)
    state = a.state()
    nxt = next(ita)
    c = CriteoTSVSource(path, SCH, **kw)
    c.set_state(state)
    np.testing.assert_array_equal(next(iter(c)).ids, nxt.ids)


def test_tsv_shuffle_covers_all_rows_permuted(tmp_path):
    path = _write_tsv(tmp_path, n=60, seed=5)
    plain = [b for b in CriteoTSVSource(path, SCH, batch_size=60)][0]
    shuf = [b for b in CriteoTSVSource(path, SCH, batch_size=60, shuffle_buffer=16, seed=1)][0]
    # same multiset of rows, different order
    assert sorted(plain.labels.tolist()) == sorted(shuf.labels.tolist())
    key_p = plain.ids[:, 0].tolist()
    key_s = shuf.ids[:, 0].tolist()
    assert key_p != key_s and sorted(key_p) == sorted(key_s)
