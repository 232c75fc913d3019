"""Pipeline tests: chunk-size invariance, engines, streaming.

Reference requirement (SURVEY.md 2.1.6 / BASELINE.json): BPE output must be
chunk-size invariant (equal to the reference run at chunk >= file size) for
file-loaded tables; basic/passthrough invariant by construction. Also pins
determinism (same input => identical bytes across chunk sizes), standing in
for the reference's race-safety guarantees (SURVEY.md 5).
"""

import os

import numpy as np
import pytest

import blt_tpu as blt
from blt_tpu.config import CoreConfig, ContentType, Engine
from blt_tpu.merges import MergeTable
from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu.pipeline.runner import run_tokenizer


def run_with(tmp_path, data: bytes, engine: Engine, chunksize=None, merges_text=None,
             passthrough=False, content_type=None):
    ip = tmp_path / "in.bin"
    op = tmp_path / "out.bin"
    ip.write_bytes(data)
    mp = None
    if merges_text is not None:
        mp = tmp_path / "merges.txt"
        mp.write_text(merges_text)
    config = CoreConfig.new_from_cli(
        input=ip,
        output=op,
        merges=mp,
        content_type=content_type,
        chunksize=chunksize,
        passthrough=passthrough,
        engine=engine,
    )
    run_tokenizer(config)
    return op.read_bytes()


MERGES_TEXT = "97 98\n98 99\n99 97\n"
MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    # heavy in 'abc' so merges fire often, with long match runs
    return rng.choice(
        np.frombuffer(b"abcabcaabbcc", np.uint8), size=700_000
    ).tobytes()


def expected_bpe(data: bytes) -> bytes:
    return tokens_to_be_bytes(bpe_encode_oracle(data, MERGES))


@pytest.mark.parametrize("engine", [Engine.NUMPY, Engine.JAX])
def test_bpe_chunk_size_invariance(tmp_path, corpus, engine):
    expected = expected_bpe(corpus)
    outs = {
        cs: run_with(tmp_path, corpus, engine, chunksize=cs, merges_text=MERGES_TEXT)
        for cs in [None, "256KB", "400000", "1MB"]
    }
    for cs, out in outs.items():
        assert out == expected, f"chunksize={cs} engine={engine}"


@pytest.mark.parametrize("engine", [Engine.NUMPY, Engine.JAX])
def test_basic_mode_pipeline(tmp_path, corpus, engine):
    out = run_with(tmp_path, corpus, engine, chunksize="256KB")
    assert out == np.frombuffer(corpus, np.uint8).astype(">u2").tobytes()


def test_passthrough_pipeline(tmp_path, corpus):
    out = run_with(tmp_path, corpus, Engine.NUMPY, chunksize="256KB", passthrough=True)
    assert out == corpus


def test_passthrough_kernel_copy_with_header(tmp_path, corpus):
    """file->file passthrough takes the kernel zero-copy path; the
    content-type header must land before the raw-fd copy."""
    ip = tmp_path / "in.bin"
    op = tmp_path / "out.bin"
    ip.write_bytes(corpus)
    config = CoreConfig.new_from_cli(
        input=ip, output=op, passthrough=True, content_type=ContentType.VIDEO
    )
    run_tokenizer(config)
    assert op.read_bytes() == bytes([0xFF, 0x04]) + corpus


def test_passthrough_kernel_copy_midstream_fallback(tmp_path, monkeypatch):
    """copy_file_range failing after partial progress must resume with
    bounded reads and still produce a byte-exact output."""
    import blt_tpu.io.sources as sources

    corpus = os.urandom(300_000)
    ip = tmp_path / "in.bin"
    op = tmp_path / "out.bin"
    ip.write_bytes(corpus)

    real = os.copy_file_range
    calls = {"n": 0}

    def flaky(in_fd, out_fd, count, offset_src=None, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError(5, "injected mid-stream failure")
        # small chunks so the failure lands mid-copy
        return real(in_fd, out_fd, min(count, 64 * 1024), offset_src=offset_src)

    monkeypatch.setattr(sources.os, "copy_file_range", flaky, raising=False)
    src, writer = sources.setup_io(ip, op)
    try:
        assert sources.kernel_copy(src, writer)
    finally:
        writer.close()
    assert op.read_bytes() == corpus
    assert calls["n"] == 2  # second call raised; the rest went via pread


def test_passthrough_kernel_copy_empty_file(tmp_path):
    ip = tmp_path / "in.bin"
    op = tmp_path / "out.bin"
    ip.write_bytes(b"")
    config = CoreConfig.new_from_cli(input=ip, output=op, passthrough=True)
    run_tokenizer(config)
    assert op.read_bytes() == b""


def test_content_type_with_bpe(tmp_path):
    data = b"ababab"
    out = run_with(
        tmp_path,
        data,
        Engine.NUMPY,
        merges_text="97 98\n",
        content_type=ContentType.AUDIO,
    )
    assert out == bytes([0xFF, 0x02]) + tokens_to_be_bytes([256, 256, 256])


def test_nonflat_table_per_chunk_semantics(tmp_path):
    """Hierarchical tables fall back to per-chunk reference semantics."""
    data = b"abcde" * 100
    ip = tmp_path / "in.bin"
    op = tmp_path / "out.bin"
    ip.write_bytes(data)
    merges = {(97, 98): 256, (256, 99): 257}
    config = CoreConfig.new_from_cli(input=ip, output=op, engine=Engine.NUMPY)
    config.with_merges(merges)
    run_tokenizer(config)
    # single chunk (file < chunk size) -> whole-input oracle semantics
    assert op.read_bytes() == tokens_to_be_bytes(bpe_encode_oracle(data, merges))


def test_deterministic_across_runs(tmp_path, corpus):
    a = run_with(tmp_path, corpus, Engine.NUMPY, merges_text=MERGES_TEXT)
    b = run_with(tmp_path, corpus, Engine.NUMPY, merges_text=MERGES_TEXT)
    assert a == b


def test_jax_engine_ragged_stream_chunks():
    """Stream reads can be short at any point (reference pipeline.rs:311);
    the device engines' carry protocol must be exact for ragged batches."""
    from blt_tpu.pipeline.engines import JaxEngine

    rng = np.random.default_rng(11)
    table = MergeTable.build(MERGES)
    data = rng.choice(np.frombuffer(b"abcabcaabbcc", np.uint8), 40_000).astype(
        np.uint8
    )
    # ragged split: sizes 1..5000, nothing aligned
    chunks = []
    pos = 0
    szs = [1, 4999, 37, 2048, 3, 5000]
    i = 0
    while pos < data.shape[0]:
        k = min(szs[i % len(szs)], data.shape[0] - pos)
        chunks.append(data[pos : pos + k])
        pos += k
        i += 1
    engine = JaxEngine()
    out = b"".join(engine.bpe_stream(iter(chunks), table, 8192))
    assert out == tokens_to_be_bytes(bpe_encode_oracle(data.tobytes(), MERGES))


def test_stdin_streaming_cli_parity(tmp_path):
    """File path and stream path must produce identical bytes."""
    import subprocess
    import sys

    data = (b"abcabc" * 5000)[:-1]
    mp = tmp_path / "m.txt"
    mp.write_text(MERGES_TEXT)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "blt_tpu.cli", "--merges", str(mp),
         "--chunksize", "256KB"],
        input=data, capture_output=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    ip = tmp_path / "in.bin"
    op = tmp_path / "out.bin"
    ip.write_bytes(data)
    run_tokenizer(
        CoreConfig.new_from_cli(
            input=ip, output=op, merges=mp, chunksize="256KB",
            engine=Engine.NUMPY,
        )
    )
    assert r.stdout == op.read_bytes()


def test_partial_output_removed_on_failure(tmp_path, monkeypatch):
    """A failed file-target run must not leave a truncated output file
    (deliberate improvement over the reference, SURVEY.md 5)."""
    import blt_tpu.pipeline.runner as runner
    from blt_tpu.config import CoreConfig

    inp = tmp_path / "in.bin"
    outp = tmp_path / "out.bin"
    inp.write_bytes(b"x" * 4096)

    def boom(results, writer):
        writer.write(b"partial")
        raise IOError("injected chunk failure")

    monkeypatch.setattr(runner, "_drain_to_writer", boom)
    cfg = CoreConfig.new_from_cli(input=str(inp), output=str(outp))
    with pytest.raises(IOError, match="injected"):
        runner.run_tokenizer(cfg)
    assert not outp.exists()


def test_partial_output_removed_when_close_also_fails(tmp_path, monkeypatch):
    """The cleanup close may itself raise (ENOSPC flushing buffered data);
    the unlink must still run and the ORIGINAL error must surface."""
    import blt_tpu.pipeline.runner as runner
    from blt_tpu.config import CoreConfig
    from blt_tpu.io.sources import OutputWriter

    inp = tmp_path / "in.bin"
    outp = tmp_path / "out.bin"
    inp.write_bytes(b"x" * 4096)

    def boom(results, writer):
        writer.write(b"partial")
        raise IOError("injected chunk failure")

    real_flush = OutputWriter.flush

    def bad_flush(self):
        real_flush(self)
        raise OSError(28, "injected ENOSPC on flush")

    monkeypatch.setattr(runner, "_drain_to_writer", boom)
    monkeypatch.setattr(OutputWriter, "flush", bad_flush)
    cfg = CoreConfig.new_from_cli(input=str(inp), output=str(outp))
    with pytest.raises(IOError, match="injected chunk failure"):
        runner.run_tokenizer(cfg)
    assert not outp.exists()


def test_profile_trace_written(tmp_path, monkeypatch):
    """BLT_PROFILE=<dir> wraps the run in a JAX profiler trace (SURVEY.md 5:
    the rebuild's observability adds real device traces)."""
    prof = tmp_path / "trace"
    monkeypatch.setenv("BLT_PROFILE", str(prof))
    out = run_with(tmp_path, b"hello profiler", Engine.NUMPY)
    assert out == bytes(
        b for ch in b"hello profiler" for b in (0, ch)
    )
    # jax.profiler.trace writes plugins/profile/<run>/ under the log dir
    produced = list(prof.rglob("*.xplane.pb"))
    assert produced, f"no xplane trace under {prof}"


def test_e2e_fuzz_bounded():
    """Bounded slice of the end-to-end differential fuzzer
    (tools/fuzz_e2e.py): random tables/corpora/chunk sizes/headers through
    the real pipeline on all three engines, vs the oracle."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import fuzz_e2e

    rng = np.random.default_rng(42)
    for t in range(6):
        fuzz_e2e.one_trial(rng, t, max_bytes=60_000)


def test_e2e_fuzz_multiproc_bounded():
    """Bounded slice of the REAL multi-process execution fuzz leg
    (tools/fuzz_e2e.py one_multiproc_trial): 2-3 actual jax.distributed
    CPU processes, one shared output, byte-compared to single-process —
    including decode and non-flat chunk-grid alignment by seed choice."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import fuzz_e2e

    rng = np.random.default_rng(7)
    for t in range(2):
        fuzz_e2e.one_multiproc_trial(rng, t, max_bytes=50_000)


def test_probe_device_engine_raises_when_device_engine_fails(monkeypatch):
    """Once JAX reports an accelerator, a failure to build the device
    engine must raise, never hide behind a silent host run."""
    from blt_tpu.pipeline import engines as eng

    monkeypatch.setattr(eng, "backend_platform", lambda: "gpu")

    def broken(*a, **k):
        raise RuntimeError("device runtime broken")

    monkeypatch.setattr(eng.JaxEngine, "__init__", broken)
    monkeypatch.setattr(eng.ShardedJaxEngine, "__init__", broken)
    with pytest.raises(RuntimeError, match="device runtime broken"):
        eng._probe_device_engine()
    with pytest.raises(RuntimeError, match="device runtime broken"):
        eng.select_engine(Engine.AUTO, eng.AUTO_DEVICE_THRESHOLD)
    # no accelerator: AUTO keeps the host engine, the probe builds nothing
    monkeypatch.setattr(eng, "backend_platform", lambda: "cpu")
    assert eng._probe_device_engine() is None
    assert isinstance(
        eng.select_engine(Engine.AUTO, eng.AUTO_DEVICE_THRESHOLD),
        eng.NumpyEngine,
    )


def test_device_mid_stream_failure_raises(monkeypatch):
    """A device fault after output has started must propagate, never
    silently re-emit the stream through another path."""
    from blt_tpu.ops import bpe_jax
    from blt_tpu.pipeline.engines import JaxEngine

    real = bpe_jax.flat_encode
    calls = {"n": 0}

    def faulty(*args, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("device fault mid-stream")
        return real(*args, **kw)

    monkeypatch.setattr(bpe_jax, "flat_encode", faulty)
    engine = JaxEngine(depth=0)
    table = MergeTable.build(MERGES)
    chunks = [np.frombuffer(b"abcabcab", np.uint8)] * 6
    stream = engine.bpe_stream(iter(chunks), table, 8)
    first = next(stream)  # output has started
    assert bytes(first) == expected_bpe(b"abcabcab")[: len(bytes(first))]
    with pytest.raises(RuntimeError, match="device fault mid-stream"):
        list(stream)


def test_auto_stream_small_pipe_stays_numpy():
    from blt_tpu.pipeline import engines as eng

    auto = eng.AutoStreamEngine()
    chunks = [np.frombuffer(b"hello", np.uint8)]
    out = b"".join(auto.basic_stream(iter(chunks), 1024))
    assert out == bytes(b for ch in b"hello" for b in (0, ch))
    assert isinstance(auto.selected, eng.NumpyEngine)


def test_auto_stream_large_pipe_selects_device(monkeypatch):
    """A pipe crossing the AUTO threshold must commit to the device engine
    when an accelerator is present, with no bytes lost
    or re-emitted around the switch."""
    from blt_tpu.pipeline import engines as eng

    picked = {}

    class FakeDeviceEngine(eng.NumpyEngine):
        name = "fake-device"

    def fake_probe():
        picked["probed"] = True
        return FakeDeviceEngine()

    monkeypatch.setattr(eng, "_probe_device_engine", fake_probe)
    monkeypatch.setattr(eng, "AUTO_DEVICE_THRESHOLD", 1024)

    rng = np.random.default_rng(3)
    chunks = [rng.integers(0, 256, 300, dtype=np.uint8) for _ in range(8)]
    auto = eng.AutoStreamEngine()
    out = b"".join(auto.basic_stream(iter(chunks), 300))
    expected = b"".join(c.astype(">u2").tobytes() for c in chunks)
    assert out == expected
    assert picked.get("probed")
    assert auto.selected.name == "fake-device"


def test_auto_engine_selection_for_streams():
    from blt_tpu.config import Engine
    from blt_tpu.pipeline import engines as eng

    assert isinstance(eng.select_engine(Engine.AUTO, None), eng.AutoStreamEngine)
    assert isinstance(eng.select_engine(Engine.AUTO, 1000), eng.NumpyEngine)


def test_auto_stream_peek_honors_memcap(monkeypatch):
    """The AUTO selection peek buffers at most min(32MB, memcap budget)
    bytes: with a small budget, the engine must commit
    after the budget's worth of chunks, not after the full 32MB default."""
    from blt_tpu.pipeline import engines as eng

    committed = {}

    class FakeDeviceEngine(eng.NumpyEngine):
        name = "fake-device"

    def fake_probe():
        return FakeDeviceEngine()

    monkeypatch.setattr(eng, "_probe_device_engine", fake_probe)

    seen = []

    def chunk_gen():
        for i in range(100):
            c = np.full(100, i % 251, np.uint8)
            seen.append(i)
            yield c

    auto = eng.AutoStreamEngine(mem_budget=512)
    assert auto.peek_threshold == 512
    out = b"".join(auto.basic_stream(chunk_gen(), 100))
    # commit happened after ~512 bytes = 6 chunks, not after all 100
    # chunks were buffered; the stream is still complete and in order
    assert auto.selected.name == "fake-device"
    assert len(out) == 2 * 100 * 100
    exp = b"".join(
        np.full(100, i % 251, np.uint8).astype(">u2").tobytes()
        for i in range(100)
    )
    assert out == exp
    committed["after"] = seen  # generator fully consumed by replay

    # a budget above the default leaves the default threshold in place
    assert (
        eng.AutoStreamEngine(mem_budget=1 << 40).peek_threshold
        == eng.AUTO_DEVICE_THRESHOLD
    )
    # no budget: unchanged default
    assert eng.AutoStreamEngine().peek_threshold == eng.AUTO_DEVICE_THRESHOLD


def test_plan_feed_size_full_batches_and_ladder():
    """Full device-sized batches: one compile shape shared by every large
    run, instead of a device program per file size."""
    from blt_tpu.pipeline.runner import _plan_feed_size

    mb = 1024 * 1024
    # large file: full 16MB batches regardless of exact size
    assert _plan_feed_size(100 * mb, 16 * mb, 16 * mb) == 16 * mb
    assert _plan_feed_size(100 * mb + 5, 16 * mb, 16 * mb) == 16 * mb
    # small file: one batch of the same shape
    assert _plan_feed_size(10 * mb, 16 * mb, 16 * mb) == 16 * mb
    # an explicit larger --chunksize raises the batch size
    assert _plan_feed_size(100 * mb, 32 * mb, 16 * mb) == 32 * mb
    # unknown size (stdin): fall back to max(chunk, dev)
    assert _plan_feed_size(None, 4 * mb, 16 * mb) == 16 * mb
    assert _plan_feed_size(0, 32 * mb, 16 * mb) == 32 * mb


def test_payload_auto_engine_probe_is_single_flight(monkeypatch):
    """Concurrent first large requests must probe the device engine
    exactly once, and the loser of the race must still get the probed
    engine (no silent host fallback)."""
    import threading

    from blt_tpu.pipeline import engines as eng

    probes = {"n": 0}
    gate = threading.Event()

    class FakeDevice(eng.NumpyEngine):
        name = "fake-device"

    def slow_probe():
        gate.wait(5)
        probes["n"] += 1
        return FakeDevice()

    monkeypatch.setattr(eng, "_probe_device_engine", slow_probe)
    auto = eng.PayloadAutoEngine(device_threshold=100)
    results = []

    def worker():
        results.append(auto.select(1000).name)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert probes["n"] == 1
    assert results == ["fake-device"] * 4
