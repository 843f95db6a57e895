"""The native-UDF layer against the reference.

* the per-byte word-start flags against the reference's Pallas kernel
  (``_word_starts_pallas``, interpret mode on the CPU), on pools of every
  length class around its 1024-byte blocks;
* K5's plain version (``word_counts_plain``) against the reference's
  ``_word_count_columnar`` on the word-count edge cases the card tests
  also run (``tests/test_torch_cuda_kernels.py``);
* ``string_word_count`` against the reference's (same planes in, same
  counts out), against the row function, and on rows that start
  mid-pool (offsets that skip bytes);
* the numeric native UDF of the reference's own test;
* on a CUDA tensor the K5 wrapper launches its kernel or raises: with no
  kernel library it raises and never runs the plain version; the flags
  have no card path.
"""
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (x64 enable)
import jax.numpy as jnp

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import schema_of as jschema_of
from spark_rapids_tpu.expr import eval as JEV
from spark_rapids_tpu.expr import expressions as JE
from spark_rapids_tpu.expr.values import StrV as JStrV
from spark_rapids_tpu.udf import native as RN
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.expr import eval as EV
from spark_rapids_tpu_torch.expr import expressions as E
from spark_rapids_tpu_torch.expr.values import ColV, StrV
from spark_rapids_tpu_torch.ops import udf_kernels as K
from spark_rapids_tpu_torch.udf import native as N
from spark_rapids_tpu_torch.udf import string_word_count, tpu_udf

from test_torch_cuda_kernels import WORD_COUNT_CASES, word_count_case
from test_torch_strings import sample_strings, strvs

#: whitespace, letters, a UTF-8 lead byte, NUL and the bytes next to the
#: whitespace range
ALPHABET = np.array([0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x61, 0x62, 0xC3,
                     0x00, 0x08, 0x0E, 0x1F, 0x21], np.uint8)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 1023, 1024, 1025, 3000])
def test_word_starts_plain_matches_pallas_kernel(n):
    c = np.random.default_rng(n).choice(ALPHABET, n)
    ref = np.asarray(RN._word_starts_pallas(jnp.asarray(c)))
    got = K.word_starts(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fill", [0x20, 0x61])
def test_word_starts_plain_all_space_and_no_space(fill):
    c = np.full(2049, fill, np.uint8)
    np.testing.assert_array_equal(
        K.word_starts(torch.from_numpy(c)).numpy(),
        np.asarray(RN._word_starts_pallas(jnp.asarray(c))))


@pytest.mark.parametrize("name", WORD_COUNT_CASES)
def test_word_counts_plain_matches_reference(name):
    """K5's plain version against the reference's columnar word count
    (its Pallas kernel in interpret mode, then its prefix-sum reduction)
    on the same planes, every row."""
    off, chars = word_count_case(name)
    rows = off.size - 1
    ref = RN._word_count_columnar(rows, JStrV(
        jnp.asarray(off), jnp.asarray(chars), jnp.ones(rows, bool)))
    got = K.word_counts(torch.from_numpy(off), torch.from_numpy(chars))
    assert got.dtype == torch.int32 and got.shape == (rows,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.data))
    # and the row function on every live row
    live = [N._word_count_row(bytes(chars[a:b]).decode("utf-8", "replace"))
            for a, b in zip(off[:-1], off[1:])]
    assert got.numpy().tolist() == live


def _text_rows(seed, n):
    """Rows of the chip check's word-count text (``chip_smoke.py`` Q10)
    and each row's word count."""
    import chip_smoke

    off, chars, valid, words = chip_smoke.word_count_text(
        np, np.random.default_rng(seed), n)
    rows = [bytes(chars[a:b]).decode() if v else None
            for a, b, v in zip(off[:-1], off[1:], valid)]
    return rows, words.tolist()


@pytest.mark.parametrize("source", ["text", "samples_ascii", "samples_utf8"])
def test_string_word_count_matches_reference_and_rows(source):
    if source == "text":
        vals, words = _text_rows(3, 2000)
    else:
        vals = sample_strings(51 if source == "samples_ascii" else 52, 500,
                              source == "samples_ascii")
        vals += ["", "   ", " a", "a ", "\x0b\x0c", "x" * 3000,
                 "one-token", " a b c d e f g "]
        words = None
    js, ps = strvs(vals)
    cap = int(js.validity.shape[0])
    ref = RN._word_count_columnar(cap, js)
    got = N._word_count_columnar(cap, ps)
    rv = np.asarray(ref.validity)
    np.testing.assert_array_equal(got.validity.numpy(), rv)
    assert got.data.dtype == torch.int32
    np.testing.assert_array_equal(got.data.numpy()[rv],
                                  np.asarray(ref.data)[rv])
    rows = [N._word_count_row(v) for v in vals]
    assert rows == [RN._word_count_row(v) for v in vals]
    assert got.data.numpy()[:len(vals)][rv[:len(vals)]].tolist() == [
        r for r in rows if r is not None]
    if words is not None:
        assert rows == [None if v is None else w
                        for v, w in zip(vals, words)]


def test_word_count_rows_starting_mid_pool():
    """Offsets that skip bytes: each row starts inside the pool, some right
    after a non-space byte of the skipped stretch (the reference's fix
    term), some after a space."""
    pool = b"xx ab  cd\tef gh ij  kl mn\nop qr st uv wx yz"
    rng = np.random.default_rng(9)
    cuts = np.sort(rng.choice(np.arange(1, len(pool)), 24, replace=False))
    cap = 11
    starts, ends = cuts[0:22:2], cuts[1:22:2]
    # rows [start_i, end_i) with gaps between them: offsets are per-row
    # starts; a row's end is the next row's start, so widen the last
    offsets = np.concatenate([starts, [ends[-1]]]).astype(np.int32)
    chars = np.frombuffer(pool, np.uint8).copy()
    valid = np.ones(cap, bool)
    ref = RN._word_count_columnar(cap, JStrV(jnp.asarray(offsets),
                                             jnp.asarray(chars),
                                             jnp.asarray(valid)))
    got = N._word_count_columnar(cap, StrV(torch.from_numpy(offsets),
                                           torch.from_numpy(chars),
                                           torch.from_numpy(valid)))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    expect = [N._word_count_row(pool[a:b].decode())
              for a, b in zip(offsets[:-1], offsets[1:])]
    assert got.data.numpy().tolist() == expect


def test_string_word_count_through_projection_matches_reference():
    vals = sample_strings(61, 300, False)
    jb = JBatch.from_pydict({"s": vals}, jschema_of(s=JT.STRING))
    jc = jb.columns[0]
    from spark_rapids_tpu_torch.columnar import batch_from_host_arrays

    pb = batch_from_host_arrays(
        schema_of(s=T.STRING), [(np.asarray(jc.offsets),
                                 np.asarray(jc.chars))],
        [np.asarray(jc.validity)], len(vals), jb.capacity, device="cpu")
    ref = JEV.evaluate_projection(
        [JE.bind_references(RN.string_word_count(JE.col("s")),
                            jb.schema)], jb)
    got = EV.evaluate_projection(
        [E.bind_references(string_word_count(E.col("s")), pb.schema)], pb)
    assert got[0].dtype == T.INT
    assert got[0].to_host().to_pylist() == ref[0].to_pylist()


def test_native_udf_numeric():
    """The reference's ``test_native_udf_numeric``: the same UDF registered
    in the port and in the reference, run through each one's projection
    on the same batch."""
    from spark_rapids_tpu.expr.values import ColV as JColV

    def row(a, b):
        if a is None or b is None:
            return None
        return a * 2 + b

    def columnar(cap, a, b):
        return ColV(a.data * 2 + b.data, a.validity & b.validity)

    def jcolumnar(cap, a, b):
        return JColV(a.data * 2 + b.data, a.validity & b.validity)

    f = tpu_udf(columnar, row, T.LONG)
    jf = RN.tpu_udf(jcolumnar, row, JT.LONG)
    data = {"a": [1, None, 3, -5], "b": [10, 20, None, 40]}
    schema = schema_of(a=T.LONG, b=T.LONG)
    jschema = jschema_of(a=JT.LONG, b=JT.LONG)
    batch = ColumnarBatch.from_pydict(data, schema, device="cpu")
    jbatch = JBatch.from_pydict(data, jschema)
    [r] = EV.evaluate_projection(
        [E.bind_references(E.Multiply(f(E.col("a"), E.col("b")), E.lit(3)),
                           schema)], batch)
    [ref] = JEV.evaluate_projection(
        [JE.bind_references(JE.Multiply(jf(JE.col("a"), JE.col("b")),
                                        JE.lit(3)), jschema)], jbatch)
    got = r.to_host().to_pylist()
    assert got == ref.to_pylist()
    rows = [row(a, b) for a, b in zip(data["a"], data["b"])]
    assert got == [None if x is None else 3 * x
                   for x in rows] == [36, None, None, 90]
    assert f.row_fn is row and f.columnar_fn is columnar


class _CardTensor:
    """Stands for a tensor on a CUDA card (this machine has none): the
    wrappers read only its dtype, rank, shape and device before they
    build."""

    device = torch.device("cuda")

    def __init__(self, dtype=torch.uint8, shape=(8,)):
        self.dtype, self.shape = dtype, shape

    def dim(self):
        return len(self.shape)

    def is_floating_point(self):
        return self.dtype.is_floating_point


def test_word_starts_raises_on_the_card_without_its_library(monkeypatch,
                                                            tmp_path):
    """On a card tensor the flags have no path (they stay in K5's
    registers), and K5's wrapper with no kernel library raises: neither
    runs a plain version."""
    from spark_rapids_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(K, "_LIB", None)
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def no_plain(*args):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(K, "word_starts_plain", no_plain)
    monkeypatch.setattr(K, "word_counts_plain", no_plain)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel for device cuda"):
        K.word_starts(_CardTensor())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.word_counts(_CardTensor(torch.int32, (9,)), _CardTensor())
    assert K.LAUNCHES == before


def test_word_starts_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="uint8"):
        K.word_starts(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device"):
        K.word_starts(torch.zeros(4, dtype=torch.uint8, device="meta"))


def test_word_counts_rejects_what_the_kernel_does_not_take():
    chars = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        K.word_counts(torch.zeros(2, dtype=torch.int32), chars.int())
    with pytest.raises(ValueError, match="integer offsets"):
        K.word_counts(torch.zeros(2), chars)
    with pytest.raises(ValueError, match="integer offsets"):
        K.word_counts(torch.zeros(0, dtype=torch.int32), chars)
    with pytest.raises(ValueError, match="offsets on"):
        K.word_counts(torch.zeros(2, dtype=torch.int32, device="meta"),
                      chars)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.word_counts(torch.zeros(2, dtype=torch.int32, device="meta"),
                      torch.zeros(4, dtype=torch.uint8, device="meta"))
