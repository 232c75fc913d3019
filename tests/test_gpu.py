"""Device programs at real widths on the card, against the NumPy reference.

Marked ``gpu``: each test asks the ``gpu`` fixture, which skips unless JAX's
default device is a GPU. Run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Every op is integer, so every comparison is bit-exact.
"""

import numpy as np
import pytest

from blt_tpu.merges import MergeTable
from blt_tpu.ops import bpe_numpy
from blt_tpu.utils import synth

pytestmark = pytest.mark.gpu

MiB = 1 << 20
BATCH = 16 * MiB  # runner.DEVICE_BATCH_BYTES


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's device is {jax.devices()[0]}")
    from blt_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    return jax.devices()[0]


@pytest.fixture(scope="module")
def workload():
    sample = synth.zipf_text(0, 4 * MiB)
    flat = synth.top_pair_merges(sample)
    hier = synth.hierarchical_merges(sample[:MiB], flat)
    data = synth.zipf_text(1, 2 * BATCH)
    return MergeTable.build(flat), MergeTable.build(hier), data


def test_basic_encode_16mib(gpu, workload):
    import jax.numpy as jnp

    from blt_tpu.ops import bpe_jax

    data = workload[2][:BATCH]
    out = np.asarray(bpe_jax.basic_encode(jnp.asarray(data)))
    assert out.tobytes() == data.astype(">u2").tobytes()


@pytest.mark.parametrize("split", [BATCH, BATCH - 1, BATCH // 3])
def test_flat_encode_16mib_chained(gpu, workload, split):
    """Two batches stitched by carry-in and next-byte equal one sequence."""
    import jax.numpy as jnp

    from blt_tpu.ops import bpe_jax

    table, _, data = workload
    a, b = data[:split], data[split : 2 * BATCH]
    dense = bpe_jax.dense_table_device(table)
    cap = BATCH

    def pad(x):
        buf = np.zeros(cap, np.uint8)
        buf[: x.size] = x
        return jnp.asarray(buf)

    _, ca, carry, be_a = bpe_jax.flat_encode(
        pad(a), jnp.int32(a.size), dense, jnp.asarray(False),
        jnp.int32(int(b[0])))
    want_a, want_carry = bpe_numpy.bpe_encode_flat_carry(
        a, table, False, int(b[0]))
    assert bool(carry) == want_carry
    got = np.asarray(be_a)[: int(ca)].tobytes()
    tail = b
    while tail.size:
        piece = tail[:cap]
        nxt = int(tail[cap]) if tail.size > cap else -1
        _, cb, carry, be_b = bpe_jax.flat_encode(
            pad(piece), jnp.int32(piece.size), dense, carry, jnp.int32(nxt))
        got += np.asarray(be_b)[: int(cb)].tobytes()
        tail = tail[cap:]
    whole = bpe_numpy.bpe_encode_flat(data, table)
    assert got == whole.astype(">u2").tobytes()


def test_multipass_encode_hierarchical(gpu, workload):
    import jax.numpy as jnp

    from blt_tpu.ops import bpe_jax

    _, htable, data = workload
    chunk = data[: 4 * MiB]
    keys, vals = bpe_jax.sparse_table_device(htable)
    toks, count = bpe_jax.multipass_encode(
        jnp.asarray(chunk), jnp.int32(chunk.size), keys, vals)
    got = np.asarray(bpe_jax.tokens_to_be_bytes_device(toks))[: int(count)]
    want = bpe_numpy.bpe_encode_multipass(chunk, htable)
    assert got.tobytes() == want.astype(">u2").tobytes()


def test_sharded_flat_encode_one_device_mesh(gpu, workload):
    import jax

    from blt_tpu.parallel.mesh import make_mesh, replicated, row_sharding
    from blt_tpu.parallel.mesh import vec_sharding
    from blt_tpu.parallel.sharded import sharded_flat_encode

    table, _, data = workload
    mesh = make_mesh([gpu])
    rows = data[:BATCH].reshape(1, BATCH)
    tokens, counts, _ = sharded_flat_encode(
        jax.device_put(rows, row_sharding(mesh)),
        jax.device_put(np.array([BATCH], np.int32), vec_sharding(mesh)),
        jax.device_put(table.dense, replicated(mesh)))
    got = np.asarray(tokens)[0, : int(counts[0])]
    want = bpe_numpy.bpe_encode_flat(data[:BATCH], table)
    assert np.array_equal(got, want)


def test_jax_engine_bpe_stream_exact(gpu, workload):
    """The engine's own pipelined stream at the CLI's batch size."""
    from blt_tpu.pipeline.engines import JaxEngine

    table, _, data = workload
    chunks = [data[i : i + BATCH] for i in range(0, data.size, BATCH)]
    got = b"".join(bytes(x) for x in
                   JaxEngine().bpe_stream(iter(chunks), table, BATCH))
    assert got == bpe_numpy.bpe_encode_flat(data, table).astype(">u2").tobytes()
