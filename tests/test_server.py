"""HTTP tokenization service tests.

The REST API is listed in the reference's architecture diagram and roadmap
but never implemented there (SURVEY.md §1); here it exists and must match
the pipeline semantics exactly (oracle ground truth).
"""

import http.client
import threading

import pytest

from blt_tpu.ops.bpe_oracle import bpe_encode_oracle, tokens_to_be_bytes
from blt_tpu.server import make_server, tokenize_bytes_wire


@pytest.fixture(scope="module")
def server_bpe(tmp_path_factory):
    mp = tmp_path_factory.mktemp("srv") / "merges.txt"
    mp.write_text("97 98\n")
    srv = make_server(port=0, merges_path=mp)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def _request(addr, method, path, body=b""):
    conn = http.client.HTTPConnection(*addr, timeout=10)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_health_and_version(server_bpe):
    import blt_tpu

    status, body = _request(server_bpe, "GET", "/health")
    assert status == 200 and b"ok" in body
    status, body = _request(server_bpe, "GET", "/version")
    assert status == 200 and blt_tpu.__version__.encode() in body


def test_tokenize_bpe_exact(server_bpe):
    payload = b"ab c ab"
    status, wire = _request(server_bpe, "POST", "/tokenize", payload)
    assert status == 200
    expected = tokens_to_be_bytes(bpe_encode_oracle(payload, {(97, 98): 256}))
    assert wire == expected  # [256, 32, 99, 32, 256] BE (tests/cli.rs:107-140)


def test_tokenize_passthrough_with_type(server_bpe):
    status, wire = _request(
        server_bpe, "POST", "/tokenize?mode=passthrough&type=bin", b"raw"
    )
    assert status == 200
    assert wire == b"\xff\x03raw"


def test_tokenize_empty_body(server_bpe):
    status, wire = _request(server_bpe, "POST", "/tokenize?type=text", b"")
    assert status == 200
    assert wire == b"\xff\x01"


def test_bad_params(server_bpe):
    status, _ = _request(server_bpe, "POST", "/tokenize?mode=warp", b"x")
    assert status == 400
    status, _ = _request(server_bpe, "POST", "/tokenize?type=smell", b"x")
    assert status == 400
    status, _ = _request(server_bpe, "GET", "/nope")
    assert status == 404


def test_detokenize_roundtrip(server_bpe):
    payload = b"ab c ab ab"
    _, wire = _request(server_bpe, "POST", "/tokenize?type=text", payload)
    status, back = _request(server_bpe, "POST", "/detokenize?type=text", wire)
    assert status == 200 and back == payload


def test_detokenize_errors(server_bpe):
    status, body = _request(server_bpe, "POST", "/detokenize", b"\x00")
    assert status == 400 and b"odd trailing byte" in body
    # token 300: not a rule in the server's 1-rule table
    status, body = _request(server_bpe, "POST", "/detokenize", b"\x01\x2c")
    assert status == 400 and b"invalid token 300" in body
    # wrong header
    status, body = _request(server_bpe, "POST", "/detokenize?type=text",
                            b"\xff\x02\x00\x61")
    assert status == 400 and b"expected content-type header" in body


def test_wire_helper_basic_matches_oracle():
    data = bytes(range(256))
    wire = tokenize_bytes_wire(data)
    assert wire == tokens_to_be_bytes(bpe_encode_oracle(data, {}))


def test_server_engine_option_jax():
    """--engine jax serves identical bytes via the device-engine path
    (CPU backend in tests: exercises the XLA stream)."""
    import http.client

    from blt_tpu.server import make_server

    server = make_server("127.0.0.1", 0, None, 0, engine="jax")
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/tokenize", body=b"hello")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.read() == bytes(b for ch in b"hello" for b in (0, ch))
    finally:
        server.shutdown()
        server.server_close()


def test_device_capacity_hint_buckets():
    """Device engines bucket capacity to powers of two (>= 64KB floor);
    host engines keep the exact size."""
    from blt_tpu.pipeline.engines import DEVICE_HINT_FLOOR, device_capacity_hint

    class Dev:
        name = "jax"

    class Host:
        name = "numpy"

    assert device_capacity_hint(1, Dev()) == DEVICE_HINT_FLOOR
    assert device_capacity_hint(DEVICE_HINT_FLOOR, Dev()) == DEVICE_HINT_FLOOR
    assert device_capacity_hint(DEVICE_HINT_FLOOR + 1, Dev()) == 2 * DEVICE_HINT_FLOOR
    assert device_capacity_hint(100_000, Dev()) == 1 << 17
    assert device_capacity_hint(120_000, Dev()) == 1 << 17
    assert device_capacity_hint((1 << 20) + 5, Dev()) == 1 << 21
    assert device_capacity_hint(0, Dev()) == 0
    assert device_capacity_hint(123, Host()) == 123


def test_server_jax_requests_share_capacity_bucket():
    """Two different-sized payloads in one pow2 bucket must reach the
    device engine with the SAME capacity hint (one compiled kernel), and
    the wire bytes must match the host engine exactly."""
    import numpy as np

    from blt_tpu.merges import MergeTable
    from blt_tpu.pipeline.engines import JaxEngine, NumpyEngine

    table = MergeTable.build({(97, 98): 256, (99, 100): 257})
    eng = JaxEngine()
    hints = []
    orig = eng.bpe_stream

    def recording(chunks, tbl, chunk_hint):
        hints.append(chunk_hint)
        return orig(chunks, tbl, chunk_hint)

    eng.bpe_stream = recording
    rng = np.random.default_rng(5)
    host = NumpyEngine()
    for size in (100_000, 120_000):
        payload = rng.choice(
            np.frombuffer(b"abcdab", np.uint8), size=size
        ).astype(np.uint8).tobytes()
        got = tokenize_bytes_wire(payload, table=table, engine=eng)
        expected = tokenize_bytes_wire(payload, table=table, engine=host)
        assert got == expected
    assert hints == [1 << 17, 1 << 17]


def test_server_warmup_compiles_each_bucket():
    """--warmup pre-tokenizes one payload per pow2 bucket up to the cap."""
    from blt_tpu.pipeline.engines import DEVICE_HINT_FLOOR
    from blt_tpu.server import _warmup

    calls = []

    class FakeEngine:
        name = "jax"

        def bpe_stream(self, chunks, table, hint):
            calls.append(hint)
            return iter(())

        def basic_stream(self, chunks, hint):
            calls.append(hint)
            return iter(())

    _warmup(FakeEngine(), None, 4 * DEVICE_HINT_FLOOR)
    assert calls == [
        DEVICE_HINT_FLOOR, 2 * DEVICE_HINT_FLOOR, 4 * DEVICE_HINT_FLOOR
    ]


def test_server_engine_auto_routes_by_payload_size(monkeypatch):
    """--engine auto applies the CLI's AUTO policy per request: payloads
    below the threshold serve on the host engine, larger ones on the
    device engine."""
    import numpy as np

    from blt_tpu.pipeline import engines as eng
    from blt_tpu.server import make_server, tokenize_bytes_wire

    used = []

    class FakeDevice(eng.NumpyEngine):
        name = "fake-device"

        def basic_stream(self, chunks, hint):
            used.append(("device", hint))
            return super().basic_stream(chunks, hint)

    monkeypatch.setattr(eng, "_probe_device_engine", lambda: FakeDevice())

    auto = eng.PayloadAutoEngine(device_threshold=1024)
    assert auto.threshold == 1024
    small = b"x" * 100
    large = b"y" * 4096
    out_small = tokenize_bytes_wire(small, engine=auto)
    out_large = tokenize_bytes_wire(large, engine=auto)
    assert out_small == np.frombuffer(small, np.uint8).astype(">u2").tobytes()
    assert out_large == np.frombuffer(large, np.uint8).astype(">u2").tobytes()
    # exactly the large request hit the device engine
    assert [u[0] for u in used] == ["device"]
    assert auto.select(100).name == "numpy"
    assert auto.select(4096).name == "fake-device"

    # end-to-end: a server built with engine="auto" serves correctly
    srv = make_server(port=0, engine="auto")
    try:
        handler = srv.RequestHandlerClass
        assert handler.engine.name == "auto"
    finally:
        srv.server_close()


def test_server_auto_threshold_cli_parse():
    """--device-threshold parses size strings and rejects bad ones."""
    import threading

    from blt_tpu.server import main

    # bad size string -> startup error, exit 1
    assert main(["--device-threshold", "12GB", "--port", "0"]) == 1


def test_payload_auto_engine_no_device_falls_back(monkeypatch):
    from blt_tpu.pipeline import engines as eng

    monkeypatch.setattr(eng, "_probe_device_engine", lambda: None)
    auto = eng.PayloadAutoEngine(device_threshold=10)
    assert auto.select(1000).name == "numpy"  # probe returned nothing
    assert auto.select(5).name == "numpy"
