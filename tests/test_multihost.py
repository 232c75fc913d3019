"""Multi-host runner: split planning, assembly, and a REAL 2-process run.

The reference has no distributed layer; BASELINE.json configs 4-5 define
the requirement (host-sharded corpus, replicated merges, host-order
output assembly, bit-exact vs single-host). Splits are validated against
the oracle; the subprocess test launches two actual jax.distributed CPU
processes through the public CLI writing one shared output file.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from blt_tpu.config import ContentType, CoreConfig, Engine
from blt_tpu.merges import MergeTable
from blt_tpu.ops.bpe_numpy import bpe_encode_flat
from blt_tpu.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MERGES = {(97, 98): 256, (98, 99): 257, (99, 97): 258, (32, 97): 259}


def test_even_bounds():
    assert multihost.even_bounds(0, 4) == [0, 0, 0, 0, 0]
    b = multihost.even_bounds(103, 4)
    assert b[0] == 0 and b[-1] == 103
    assert all(b[i] <= b[i + 1] for i in range(4))


def test_chunk_aligned_bounds():
    b = multihost.chunk_aligned_bounds(1000, 64, 3)
    assert b[0] == 0 and b[-1] == 1000
    for x in b[1:-1]:
        assert x % 64 == 0


def test_safe_split_bounds_are_transparent():
    """Every interior bound must sit at a non-rule pair, and per-range
    independent encoding must equal whole-stream encoding."""
    table = MergeTable.build(MERGES)
    rng = np.random.default_rng(21)
    mm = rng.choice(np.frombuffer(b"abcabc ab ccba", np.uint8), size=200_000)
    bounds = multihost.safe_split_bounds(mm, table.dense, 5)
    assert bounds[0] == 0 and bounds[-1] == mm.shape[0]
    for j in bounds[1:-1]:
        pair = int(mm[j - 1]) * 256 + int(mm[j])
        assert table.dense[pair] == -1  # NO_RULE: split is merge-transparent
    parts = [
        bpe_encode_flat(mm[bounds[i] : bounds[i + 1]], table)
        for i in range(5)
    ]
    got = np.concatenate(parts)
    expected = bpe_encode_flat(mm, table)
    assert got.tolist() == expected.tolist()


def test_safe_split_bounds_pathological_all_matches():
    """A corpus where every pair is a rule has no safe split: ranges
    degrade (fewer effective hosts) but stay correct."""
    table = MergeTable.build({(97, 97): 256})
    mm = np.full(10_000, 97, np.uint8)
    bounds = multihost.safe_split_bounds(mm, table.dense, 4)
    assert bounds[0] == 0 and bounds[-1] == mm.shape[0]
    assert all(b == mm.shape[0] for b in bounds[1:])  # one host does all
    parts = [
        bpe_encode_flat(mm[bounds[i] : bounds[i + 1]], table)
        for i in range(4)
    ]
    got = np.concatenate([p for p in parts if p.size])
    assert got.tolist() == bpe_encode_flat(mm, table).tolist()


def test_single_process_distributed_runner_matches(tmp_path):
    """nproc=1 exercises the spool + pwrite + truncate assembly path."""
    from blt_tpu.pipeline.runner import run_tokenizer

    rng = np.random.default_rng(3)
    data = rng.choice(np.frombuffer(b"abcab c", np.uint8), size=300_000)
    ip = tmp_path / "in.bin"
    op1 = tmp_path / "out_dist.bin"
    op2 = tmp_path / "out_ref.bin"
    mp = tmp_path / "m.txt"
    ip.write_bytes(data.tobytes())
    mp.write_text("".join(f"{a} {b}\n" for a, b in MERGES))

    cfg = CoreConfig.new_from_cli(
        input=ip, output=op1, merges=mp, engine=Engine.NUMPY
    )
    # stale pre-existing output longer than the result: truncate must fix
    op1.write_bytes(b"\xee" * 2_000_000)
    multihost.run_tokenizer_distributed(cfg)

    cfg2 = CoreConfig.new_from_cli(
        input=ip, output=op2, merges=mp, engine=Engine.NUMPY
    )
    run_tokenizer(cfg2)
    assert op1.read_bytes() == op2.read_bytes()


def test_spool_spills_to_disk_beyond_budget(tmp_path, monkeypatch):
    """A tiny spool budget forces the memory-first spool to spill to a
    temp file mid-run; output stays byte-identical and nothing leaks."""
    from blt_tpu.pipeline.runner import run_tokenizer

    spills = []
    real_spill = multihost._Spool._spill

    def spy(self):
        spills.append(self.bytes)
        return real_spill(self)

    monkeypatch.setattr(multihost, "_spool_budget", lambda cfg: 10_000)
    monkeypatch.setattr(multihost._Spool, "_spill", spy)
    rng = np.random.default_rng(6)
    data = rng.choice(np.frombuffer(b"abcab c", np.uint8), size=300_000)
    ip = tmp_path / "in.bin"
    op1 = tmp_path / "out_dist.bin"
    op2 = tmp_path / "out_ref.bin"
    mp = tmp_path / "m.txt"
    ip.write_bytes(data.tobytes())
    mp.write_text("".join(f"{a} {b}\n" for a, b in MERGES))

    multihost.run_tokenizer_distributed(CoreConfig.new_from_cli(
        input=ip, output=op1, merges=mp, engine=Engine.NUMPY
    ))
    run_tokenizer(CoreConfig.new_from_cli(
        input=ip, output=op2, merges=mp, engine=Engine.NUMPY
    ))
    assert op1.read_bytes() == op2.read_bytes()
    assert spills  # the budget actually forced a spill
    assert not list(tmp_path.glob(".blt_spool_*"))


def test_single_process_distributed_decode(tmp_path):
    """nproc=1 decode: token-aligned assembly, stale-output truncate,
    and the full error surface without spool leakage."""
    from blt_tpu.ops.decode import DecodeError
    from blt_tpu.pipeline.runner import run_tokenizer

    rng = np.random.default_rng(4)
    data = rng.choice(np.frombuffer(b"abcab c", np.uint8), size=200_000)
    ip = tmp_path / "in.bin"
    wire = tmp_path / "wire.bin"
    out = tmp_path / "back.bin"
    mp = tmp_path / "m.txt"
    ip.write_bytes(data.tobytes())
    mp.write_text("".join(f"{a} {b}\n" for a, b in MERGES))
    run_tokenizer(CoreConfig.new_from_cli(
        input=ip, output=wire, merges=mp, content_type=ContentType.TEXT,
        engine=Engine.NUMPY,
    ))

    cfg = CoreConfig.new_from_cli(
        input=wire, output=out, merges=mp, content_type=ContentType.TEXT,
        decode=True,
    )
    out.write_bytes(b"\xee" * 1_000_000)  # stale output: truncate must fix
    multihost.run_tokenizer_distributed(cfg)
    assert out.read_bytes() == data.tobytes()
    assert not list(tmp_path.glob(".blt_spool_*"))

    wb = wire.read_bytes()

    # header mismatch raises before any spool or output fd exists
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes([0xFF, 0x03]) + wb[2:])
    cfg_bad = CoreConfig.new_from_cli(
        input=bad, output=out, merges=mp, content_type=ContentType.TEXT,
        decode=True,
    )
    with pytest.raises(DecodeError, match="expected content-type header"):
        multihost.run_tokenizer_distributed(cfg_bad)
    assert out.read_bytes() == data.tobytes()  # output untouched on error

    # odd byte count raises
    odd = tmp_path / "odd.bin"
    odd.write_bytes(wb + b"\x00")
    cfg_odd = CoreConfig.new_from_cli(input=odd, output=out, decode=True)
    with pytest.raises(DecodeError, match="odd trailing byte"):
        multihost.run_tokenizer_distributed(cfg_odd)
    assert out.read_bytes() == data.tobytes()

    # invalid token mid-range: the spool was created and must be cleaned up,
    # and the output must not have been clobbered before the failure
    cfg_tok = CoreConfig.new_from_cli(
        input=wire, output=out, content_type=ContentType.TEXT, decode=True,
    )  # no merges: rule ids in the stream are invalid
    with pytest.raises(DecodeError, match="invalid token"):
        multihost.run_tokenizer_distributed(cfg_tok)
    assert not list(tmp_path.glob(".blt_spool_*"))
    assert out.read_bytes() == data.tobytes()


_WORKER = textwrap.dedent(
    """
    import sys
    import jax
    from blt_tpu.cli import main
    rc = main(sys.argv[1:])
    if rc == 0 and jax.process_count() != 2:
        print("DISTRIBUTED PATH NOT TAKEN", file=sys.stderr)
        rc = 3
    sys.exit(rc)
    """
)


@pytest.mark.parametrize("mode_args", [[], ["--merges", "MERGES"]])
def test_two_process_distributed_matches_single(tmp_path, mode_args):
    """Two real jax.distributed CPU processes, one shared output file,
    byte-identical to the single-process run (BASELINE configs 4-5)."""
    rng = np.random.default_rng(9)
    data = rng.choice(np.frombuffer(b"abcabc ab c", np.uint8), size=400_000)
    ip = tmp_path / "in.bin"
    op = tmp_path / "out_dist.bin"
    op_ref = tmp_path / "out_ref.bin"
    mp = tmp_path / "m.txt"
    ip.write_bytes(data.tobytes())
    mp.write_text("".join(f"{a} {b}\n" for a, b in MERGES))
    args = [a if a != "MERGES" else str(mp) for a in mode_args]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def env_for(pid):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["BLT_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["BLT_NUM_PROCESSES"] = "2"
        env["BLT_PROCESS_ID"] = str(pid)
        env["BLT_DEVICE_BATCH_BYTES"] = str(256 * 1024)
        return env

    cli = ["-i", str(ip), "-o", str(op), "--type", "text"] + args
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER] + cli,
            env=env_for(pid),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()

    # single-process reference
    r = subprocess.run(
        [sys.executable, "-m", "blt_tpu.cli", "-i", str(ip), "-o", str(op_ref),
         "--type", "text"] + args,
        env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"},
        capture_output=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()
    assert op.read_bytes() == op_ref.read_bytes()


def test_two_process_distributed_decode(tmp_path):
    """Two jax.distributed processes decoding one wire stream into one
    shared file, byte-identical to the original input."""
    rng = np.random.default_rng(13)
    data = rng.choice(np.frombuffer(b"abcabc ab c", np.uint8), size=300_000)
    ip = tmp_path / "in.bin"
    wire = tmp_path / "wire.bin"
    out = tmp_path / "back.bin"
    mp = tmp_path / "m.txt"
    ip.write_bytes(data.tobytes())
    mp.write_text("".join(f"{a} {b}\n" for a, b in MERGES))

    env1 = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "blt_tpu.cli", "-i", str(ip), "-o", str(wire),
         "--type", "bin", "--merges", str(mp)],
        env=env1, capture_output=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def env_for(pid):
        env = dict(env1)
        env["BLT_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["BLT_NUM_PROCESSES"] = "2"
        env["BLT_PROCESS_ID"] = str(pid)
        return env

    cli = ["-i", str(wire), "-o", str(out), "--type", "bin",
           "--merges", str(mp), "--decode"]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER] + cli,
            env=env_for(pid),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()
    assert out.read_bytes() == data.tobytes()
