"""The on-card tooling, on the CPU: compile-cache location, chip_smoke's
refusal to report without a card, the trace reduction, seeded workloads."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = """
import jax, jax.numpy as jnp
from blt_tpu.utils import compcache
compcache.enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: x * 7 + 3)(jnp.arange(29)).block_until_ready()
"""


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and the code
    sets no other directory; unset, it lands in <repo>/.jax_cache/."""
    from blt_tpu.utils import compcache

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    want = str(tmp_path / "cc") if env_dir else compcache.REPO_CACHE_DIR
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    assert compcache.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want
    assert any(n.startswith("jit__lambda") for n in os.listdir(want))


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_chip_smoke_fails_without_a_card():
    """On a CPU-only host the script stops at setup, exits non-zero and
    prints "ok": false last."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    last = _last_json(r.stdout)
    assert last["ok"] is False and last["failed"] == ["setup"]
    assert "no card visible" in r.stdout
    # every line before the last names the card (here: no nvidia-smi)
    card = r.stdout.splitlines()[0].split("]")[0] + "]"
    assert all(ln.startswith(card) for ln in r.stdout.splitlines()[:-1])


def test_chip_smoke_rehearsal_on_cpu():
    """Every phase of the one-card smoke test runs on the CPU at tiny
    sizes; a rehearsal passes its phases and still never reports ok."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", "--rehearse-on-cpu", "--cli-mb",
         "3", "--batch-mb", "1", "--api-mb", "2", "--serve-mb", "0.25,1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:]
    assert _last_json(r.stdout) == {"ok": False, "failed": [],
                                    "rehearsal": "cpu"}
    for phase in ("setup", "kernels", "cli", "server", "api", "gpu_tests"):
        assert f"{phase}: PASS" in r.stdout, phase
    assert r.stdout.count("identical to the host engine") >= 4


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the checkout, the script refuses to run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert _last_json(r.stdout) == {"ok": False, "failed": ["checkout"]}


def _device_trace():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import device_trace

    return device_trace


@pytest.mark.parametrize("intervals,total", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 12)], 12),
    ([(20, 30), (0, 10), (10, 15)], 25),
    ([(0, 100), (10, 20), (30, 40)], 100),
])
def test_trace_busy_union(intervals, total):
    assert _device_trace().union_ns(intervals) == total


def test_trace_reduction_on_cpu_trace(tmp_path):
    """A CPU trace has host events and no GPU plane: the window is positive
    and the device busy time is zero (never a CPU number as device time)."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x.astype(jnp.uint16) << 8)
    x = jnp.zeros(4096, jnp.uint8)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    red = _device_trace().reduce_trace(str(tmp_path))
    assert red["window_ns"] > 0
    assert red["device_busy_ns"] == 0 and red["busy_share"] == 0
    assert any(p["plane"].startswith("/host:CPU") for p in red["planes"])


def test_synth_workload_is_seeded_and_flat():
    from blt_tpu.merges import MergeTable, parse_merges_text
    from blt_tpu.utils import synth

    a = synth.zipf_text(3, 1 << 16)
    assert np.array_equal(a, synth.zipf_text(3, 1 << 16))
    assert not np.array_equal(a, synth.zipf_text(4, 1 << 16))
    assert set(np.unique(a).tobytes()) <= set(synth.ALPHABET)
    flat = synth.top_pair_merges(a)
    assert len(flat) == synth.FLAT_RULES
    assert MergeTable.build(flat).flat
    # the merges file loads back to the same table
    assert parse_merges_text(synth.merges_file_text(flat)) == flat
    # most frequent pair first
    pairs = a[:-1].astype(np.int64) * 256 + a[1:]
    top = int(np.bincount(pairs).argmax())
    assert flat[(top // 256, top % 256)] == 256


def test_synth_hierarchical_rules_fire():
    from blt_tpu.merges import MergeTable
    from blt_tpu.ops.bpe_numpy import bpe_encode_multipass
    from blt_tpu.utils import synth

    a = synth.zipf_text(5, 1 << 16)
    flat = synth.top_pair_merges(a, 50)
    hier = synth.hierarchical_merges(a, flat, 20)
    assert len(hier) == 70 and not MergeTable.build(hier).flat
    assert all(k in hier and hier[k] == v for k, v in flat.items())
    toks = bpe_encode_multipass(a, MergeTable.build(hier))
    assert int(toks.max()) >= 256 + 50  # a second-level merge fired
