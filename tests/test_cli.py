"""CLI integration tests: spawn the CLI, assert exact output bytes.

Mirrors the reference integration tier (tests/cli.rs:20-215, 7 tests) plus
the '-' stdin/stdout convention and the error surface (src/main.rs:100-103).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, stdin=b""):
    return subprocess.run(
        [sys.executable, "-m", "blt_tpu.cli"] + args,
        input=stdin,
        capture_output=True,
        env=_env(),
        timeout=120,
    )


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def u16be(values):
    return b"".join(int(v).to_bytes(2, "big") for v in values)


def test_cli_stdin_stdout():
    r = run_cli([], b"hello world")
    assert r.returncode == 0, r.stderr
    assert r.stdout == u16be(b"hello world")


def test_cli_input_output_files(tmp_path):
    ip = tmp_path / "in.txt"
    op = tmp_path / "out.bin"
    ip.write_bytes(b"hello from file")
    r = run_cli(["--input", str(ip), "--output", str(op)])
    assert r.returncode == 0, r.stderr
    assert op.read_bytes() == u16be(b"hello from file")


def test_cli_type_argument():
    r = run_cli(["--type", "text"], b"test")
    assert r.returncode == 0, r.stderr
    assert r.stdout == u16be([0xFF01]) + u16be(b"test")


@pytest.mark.parametrize(
    "name,token", [("text", 0xFF01), ("audio", 0xFF02), ("bin", 0xFF03), ("video", 0xFF04)]
)
def test_cli_all_content_types(name, token):
    r = run_cli(["--type", name], b"x")
    assert r.stdout == u16be([token, ord("x")])


def test_cli_bpe_merges(tmp_path):
    mp = tmp_path / "merges.txt"
    mp.write_text("97 98\n")
    r = run_cli(["--merges", str(mp)], b"ab c ab")
    assert r.returncode == 0, r.stderr
    # 256 (ab), 32, 99, 32, 256 — pinned by tests/cli.rs:107-140
    assert r.stdout == u16be([256, 32, 99, 32, 256])


def test_cli_chunksize_argument():
    r = run_cli(["--chunksize", "1KB"], b"some data")
    assert r.returncode == 0, r.stderr
    assert r.stdout == u16be(b"some data")


def test_cli_threads_argument():
    r = run_cli(["--threads", "1"], b"thread test")
    assert r.returncode == 0, r.stderr
    assert r.stdout == u16be(b"thread test")


def test_cli_passthrough_mode():
    r = run_cli(["--passthrough"], b"passthrough test")
    assert r.returncode == 0, r.stderr
    assert r.stdout == b"passthrough test"


def test_cli_passthrough_with_type():
    # header then raw copy (lib.rs:254-263)
    r = run_cli(["--passthrough", "--type", "bin"], b"raw")
    assert r.stdout == u16be([0xFF03]) + b"raw"


def test_cli_decode_roundtrip(tmp_path):
    mp = tmp_path / "merges.txt"
    mp.write_text("97 98\n")
    enc = run_cli(["--merges", str(mp), "--type", "text"], b"ab c ab")
    assert enc.returncode == 0, enc.stderr
    dec = run_cli(["--decode", "--merges", str(mp), "--type", "text"], enc.stdout)
    assert dec.returncode == 0, dec.stderr
    assert dec.stdout == b"ab c ab"


def test_cli_decode_error_surface():
    r = run_cli(["--decode"], b"\x01\x00")  # token 256 with no merges table
    assert r.returncode == 1
    assert r.stderr.startswith(b"Error running tokenizer: invalid token 256")


def test_cli_dash_convention(tmp_path):
    # '-' means stdin/stdout (README.md:102-103; unimplemented in reference)
    r = run_cli(["--input", "-", "--output", "-"], b"dash")
    assert r.returncode == 0, r.stderr
    assert r.stdout == u16be(b"dash")


def test_cli_empty_input():
    r = run_cli([], b"")
    assert r.returncode == 0
    assert r.stdout == b""


def test_cli_error_surface(tmp_path):
    mp = tmp_path / "bad.txt"
    mp.write_text("97\n")
    r = run_cli(["--merges", str(mp)], b"x")
    assert r.returncode == 1
    assert b"Error running tokenizer:" in r.stderr


def test_cli_missing_merges_file():
    r = run_cli(["--merges", "/nonexistent/m.txt"], b"x")
    assert r.returncode == 1
    assert b"Error running tokenizer:" in r.stderr


@pytest.mark.parametrize("value", ["300", "-1", "abc"])
def test_cli_memcap_validation(value):
    # clap types memcap as u8 (reference: src/main.rs:48-52): out-of-range
    # and non-numeric values are rejected at parse time with exit code 2.
    r = run_cli(["--memcap", value], b"x")
    assert r.returncode == 2
    assert b"--memcap" in r.stderr


@pytest.mark.parametrize("value", ["-2", "xyz"])
def test_cli_threads_validation(value):
    # clap types threads as usize (reference: src/main.rs:44-46).
    r = run_cli(["--threads", value], b"x")
    assert r.returncode == 2
    assert b"--threads" in r.stderr


def test_cli_memcap_boundary_accepted():
    r = run_cli(["--memcap", "255"], b"ok")
    assert r.returncode == 0, r.stderr
    assert r.stdout == u16be(b"ok")


class TestTrainCli:
    def test_train_cli_end_to_end(self, tmp_path):
        """Learn merges from a corpus, write reference-grammar merges.txt,
        and reload them through the strict file parser."""
        import subprocess
        import sys

        corpus = tmp_path / "corpus.txt"
        corpus.write_bytes(b"ababab cdcdcd " * 200)
        out = tmp_path / "merges.txt"
        r = subprocess.run(
            [sys.executable, "-m", "blt_tpu.train_cli", str(corpus),
             "-o", str(out), "-n", "4"],
            capture_output=True, env=_env(), timeout=560,
        )
        assert r.returncode == 0, r.stderr.decode()
        from blt_tpu.merges import load_bpe_merges_from_path

        merges = load_bpe_merges_from_path(out)
        assert len(merges) >= 1

    def test_train_cli_checkpoint_resume(self, tmp_path):
        import subprocess
        import sys

        corpus = tmp_path / "corpus.txt"
        corpus.write_bytes(b"hello world " * 300)
        out1 = tmp_path / "m1.txt"
        out2 = tmp_path / "m2.txt"
        ckpt = tmp_path / "state.npz"
        # interrupted run: small budget, checkpointing
        r = subprocess.run(
            [sys.executable, "-m", "blt_tpu.train_cli", str(corpus),
             "-o", str(out1), "-n", "2", "--rows", "2",
             "--checkpoint", str(ckpt), "--checkpoint-every", "1"],
            capture_output=True, env=_env(), timeout=560,
        )
        assert r.returncode == 0, r.stderr.decode()
        assert ckpt.exists()
        # resumed to a larger budget == clean larger run
        r = subprocess.run(
            [sys.executable, "-m", "blt_tpu.train_cli", str(corpus),
             "-o", str(out1), "-n", "5", "--rows", "2",
             "--checkpoint", str(ckpt), "--resume"],
            capture_output=True, env=_env(), timeout=560,
        )
        assert r.returncode == 0, r.stderr.decode()
        r = subprocess.run(
            [sys.executable, "-m", "blt_tpu.train_cli", str(corpus),
             "-o", str(out2), "-n", "5", "--rows", "2"],
            capture_output=True, env=_env(), timeout=560,
        )
        assert r.returncode == 0, r.stderr.decode()
        assert out1.read_text() == out2.read_text()

    def test_train_cli_empty_corpus_errors(self, tmp_path):
        import subprocess
        import sys

        corpus = tmp_path / "empty.bin"
        corpus.write_bytes(b"")
        r = subprocess.run(
            [sys.executable, "-m", "blt_tpu.train_cli", str(corpus),
             "-o", str(tmp_path / "m.txt")],
            capture_output=True, env=_env(), timeout=560,
        )
        assert r.returncode == 1
        assert b"Error training merges" in r.stderr
