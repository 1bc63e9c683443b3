"""The port's msgpack codec (``utils/msgpack.py``) against flax's, on the
CPU: ``packb`` writes the bytes of ``flax.serialization.msgpack_serialize``
and ``unpackb`` reads what ``msgpack_restore`` reads, on trees with every
dtype flax writes, 0-d, empty and large (bin32) arrays, numpy scalars,
complex numbers, nested and empty dicts, lists, long keys, every int
width, and flax's chunked arrays."""

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from understanding_flow_robustness_tpu_torch.utils import msgpack

DTYPES = ("float32", "float16", "float64", "int8", "int16", "int32",
          "int64", "uint8", "uint16", "uint32", "uint64", "bool",
          "complex64")


def _array(rng, dtype, shape):
    if dtype == "bool":
        return rng.rand(*shape) > 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.randint(max(info.min, -2 ** 31), min(info.max, 2 ** 31 - 1),
                           size=shape, dtype=np.int64).astype(dtype)
    x = rng.randn(*shape) * 10
    if dtype.startswith("complex"):
        x = x + 1j * rng.randn(*shape)
    return x.astype(dtype)


def _tree(seed):
    """A flax-side tree (numpy and ml_dtypes leaves) and the port-side one
    (the bf16 leaves as torch.bfloat16 tensors of the same bits)."""
    rng = np.random.RandomState(seed)
    arrays = {d: _array(rng, d, (3, 5)) for d in DTYPES}
    arrays["zero_d"] = np.array(3.25, np.float32)
    arrays["empty"] = np.zeros((0, 4), np.int8)
    arrays["big_bin32"] = rng.rand(3, 40, 1000).astype(np.float32)  # 480 kB
    arrays["bin16"] = rng.rand(300).astype(np.float32)
    bf = rng.randn(4, 6).astype(np.float32)
    tree = {
        "arrays": arrays,
        "bf16": bf.astype(ml_dtypes.bfloat16),
        "scalars": {"f32": np.float32(-1.5), "i64": np.int64(-7),
                    "u8": np.uint8(200), "f64": np.float64(2.0),
                    "bool": np.bool_(True), "c64": np.complex64(1 - 2j)},
        "python": [0, 127, 128, -1, -32, -33, -128, -129, 255, 256, 65535,
                   65536, -32768, -32769, 2 ** 32 - 1, 2 ** 32, -2 ** 31,
                   -2 ** 31 - 1, 2 ** 63, 2 ** 64 - 1, -2 ** 63, True, False,
                   None, 0.1, -1e300, 1 + 2j, "", "ü" * 20, "s" * 31,
                   "s" * 32, "s" * 300, "s" * 70000, b"", b"x" * 300,
                   [], [1, [2, [3]]], list(range(20)), list(range(70000))],
        "nested": {"z": {"y": {"x": {}}}, "a": {str(i): i for i in range(20)}},
        "k" * 300: np.arange(17, dtype=np.int32),
        "b": {}, "a": [{"m": np.ones(2, np.float16)}],
    }
    port = dict(tree, bf16=torch.from_numpy(bf).to(torch.bfloat16))
    assert np.array_equal(port["bf16"].view(torch.int16).numpy(),
                          tree["bf16"].view(np.int16))
    return tree, port


def _equal(got, want, path="root"):
    """Same structure, keys in the same order, same types, leaves with the
    same shape, dtype and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("seed", [0, 1])
def test_packb_writes_flax_bytes(seed):
    tree, port = _tree(seed)
    want = serialization.msgpack_serialize(tree)
    assert len(want) > 70000 and b"\xc6" in want  # a bin32 payload
    assert msgpack.packb(port) == want
    assert msgpack.packb(tree) == want  # ml_dtypes leaves by dtype name


@pytest.mark.parametrize("seed", [0, 1])
def test_unpackb_reads_what_flax_restores(seed):
    tree, _ = _tree(seed)
    data = serialization.msgpack_serialize(tree)
    _equal(msgpack.unpackb(data), serialization.msgpack_restore(data))


def test_flax_reads_the_ports_bytes():
    _, port = _tree(2)
    data = msgpack.packb(port)
    _equal(msgpack.unpackb(data), serialization.msgpack_restore(data))


def test_to_bytes_of_variables_round_trips():
    """A variables-like tree in flax's to_bytes (in place, keys already
    sorted, as jit-initialised variables are) and back."""
    rng = np.random.RandomState(3)
    v = {"batch_stats": {"bn": {"mean": rng.rand(4).astype(np.float32),
                                "var": rng.rand(4).astype(np.float32)}},
         "params": {"conv": {"bias": rng.rand(4).astype(np.float32),
                             "kernel": rng.rand(3, 3, 2, 4).astype(
                                 np.float32)}}}
    data = serialization.to_bytes(v)
    assert msgpack.packb(v) == data
    _equal(msgpack.unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("chunk", [64, 1000, 4096])
def test_chunked_arrays(monkeypatch, chunk):
    """Arrays over MAX_CHUNK_SIZE bytes (2**30 in flax) are written as
    ``__msgpack_chunked_array__`` dicts of flat chunks: the port reads
    flax's chunks back into the arrays, bf16 ones too, and writes the
    same chunks at the same limit."""
    tree, port = _tree(4)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _equal(msgpack.unpackb(data), serialization.msgpack_restore(data))
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", chunk)
    assert msgpack.packb(port) == data


def test_refusals():
    """Tuples and other objects flax's strict packer refuses, and bytes
    that are not one whole msgpack object."""
    for bad in ((1, 2), {"a": (1,)}, {"a": object()}):
        with pytest.raises(TypeError):
            msgpack.packb(bad)
        with pytest.raises(TypeError):
            serialization.msgpack_serialize(bad)
    data = msgpack.packb({"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError):
        msgpack.unpackb(data + b"\x00")
