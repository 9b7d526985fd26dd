"""Hashing / data-spec tests (frozen spec v1 — goldens guard against drift)."""

import numpy as np

from recmodels.data import hashing
from recmodels.data.schema import criteo_schema, per_slot_dims_for_vocab


def test_splitmix64_reference_values():
    # splitmix64 published test vector: seed sequence from 0 state
    # (first outputs of splitmix64 stream starting at 0, gamma added first)
    out = hashing.splitmix64(np.uint64(0))
    assert out == np.uint64(0xE220A8397B1DCDAF)


def test_hash_deterministic_and_in_range():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**63, size=(50, 26), dtype=np.uint64)
    vocab = np.full(26, 1000)
    ids1 = hashing.hash_uint64_values(vals, vocab)
    ids2 = hashing.hash_uint64_values(vals, vocab)
    np.testing.assert_array_equal(ids1, ids2)
    assert ids1.min() >= 1 and ids1.max() < 1000


def test_missing_goes_to_bucket_zero():
    vals = np.zeros((4, 26), dtype=np.uint64)
    missing = np.ones((4, 26), dtype=bool)
    ids = hashing.hash_uint64_values(vals, np.full(26, 100), missing)
    assert (ids == 0).all()


def test_slot_salting_differs_across_slots():
    vals = np.full((1, 26), 12345, dtype=np.uint64)
    ids = hashing.hash_uint64_values(vals, np.full(26, 100_000))
    # same token in different slots should map to different buckets (w.h.p.)
    assert len(np.unique(ids)) > 20


def test_hash_tokens_hex_fast_path_matches_fingerprint():
    toks = np.array([[b"0a1b2c3d", b""], [b"deadbeef", b"cafe1234"]], dtype=object)
    ids = hashing.hash_tokens(toks, [1000, 1000])
    assert ids.shape == (2, 2)
    assert ids[0, 1] == 0  # missing
    assert ids[0, 0] != 0 and ids[1, 1] != 0


def test_golden_values_frozen_spec_v1():
    # These pins make any accidental spec change loud (SURVEY.md §7 hard part 7).
    vals = np.array([[1, 2, 3]], dtype=np.uint64)
    ids = hashing.hash_uint64_values(vals, np.array([97, 1009, 100000]))
    expected = hashing.hash_fingerprints(
        vals,
        np.zeros_like(vals, bool),
        np.broadcast_to(np.arange(3), vals.shape),
        np.array([97, 1009, 100000]),
    )
    np.testing.assert_array_equal(ids, expected)
    assert ids.tolist() == [[95, 514, 45267]]


def test_schema_helpers():
    sch = criteo_schema(vocab_size=100_000, embed_dim=16)
    assert sch.n_slots == 26 and sch.uniform_dim and sch.max_dim == 16
    dims = per_slot_dims_for_vocab((10, 1000, 100000, 5_000_000), base_dim=16)
    assert len(dims) == 4 and all(d % 4 == 0 for d in dims)
    assert dims[0] <= dims[2]
    sch2 = criteo_schema(vocab_size=[1000] * 26, embed_dim=list(range(4, 30)))
    assert not sch2.uniform_dim
