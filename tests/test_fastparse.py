"""Native C++ parser vs Python parser: bit-for-bit parity on the frozen
data spec, including the nasty token cases."""

import numpy as np
import pytest

from recmodels.data import criteo_schema
from recmodels.data import fastparse
from recmodels.data.criteo import parse_criteo_batch, parse_criteo_lines

SCH = criteo_schema(vocab_size=[1000 + 37 * i for i in range(26)], embed_dim=8)

needs_native = pytest.mark.skipif(not fastparse.available(), reason="no g++/native lib")


def _lines(n=200, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    weird_tokens = [b"hello_world", b"DEADBEEF", b"0" * 17, b"abc-def", b"+1f", b"f" * 16]
    for i in range(n):
        label = str(rng.integers(0, 2)).encode()
        dense = []
        for _ in range(13):
            r = rng.random()
            if r < 0.15:
                dense.append(b"")
            elif r < 0.25:
                dense.append(str(rng.integers(-5, 0)).encode())  # negatives exist in Criteo
            else:
                dense.append(str(rng.integers(0, 50_000)).encode())
        cats = []
        for _ in range(26):
            r = rng.random()
            if r < 0.1:
                cats.append(b"")
            elif r < 0.2:
                cats.append(weird_tokens[rng.integers(0, len(weird_tokens))])
            else:
                cats.append(format(rng.integers(0, 2**32), "08x").encode())
        lines.append(b"\t".join([label, *dense, *cats]) + b"\n")
    return lines


@needs_native
def test_native_matches_python_bitwise():
    lines = _lines(300)
    py = parse_criteo_lines(lines, SCH)
    labels, dense, ids, consumed = fastparse.parse_buffer(b"".join(lines), SCH, len(lines))
    assert consumed == sum(len(l) for l in lines)
    np.testing.assert_array_equal(labels, py.labels)
    np.testing.assert_array_equal(ids, py.ids)
    np.testing.assert_allclose(dense, py.dense, rtol=1e-6, atol=1e-7)


@needs_native
def test_parse_criteo_batch_uses_native():
    lines = _lines(64, seed=1)
    a = parse_criteo_batch(lines, SCH, use_native=True)
    b = parse_criteo_batch(lines, SCH, use_native=False)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_allclose(a.dense, b.dense, rtol=1e-6, atol=1e-7)


@needs_native
def test_incomplete_trailing_line_not_consumed():
    lines = _lines(3, seed=2)
    buf = b"".join(lines) + b"1\t2\t3"  # truncated final record
    labels, dense, ids, consumed = fastparse.parse_buffer(buf, SCH, 10)
    assert len(labels) == 3
    assert consumed == sum(len(l) for l in lines)


@needs_native
def test_native_is_much_faster():
    import time

    lines = _lines(2000, seed=3)
    t0 = time.time()
    parse_criteo_lines(lines, SCH)
    t_py = time.time() - t0
    buf = b"".join(lines)
    fastparse.parse_buffer(buf, SCH, len(lines))  # warm
    t0 = time.time()
    fastparse.parse_buffer(buf, SCH, len(lines))
    t_c = time.time() - t0
    assert t_c < t_py / 5, f"native {t_c:.4f}s vs python {t_py:.4f}s"
