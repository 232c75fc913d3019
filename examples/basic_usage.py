#!/usr/bin/env python3
"""blt_tpu usage tour: the reference API surface plus the device extras.

Covers the same ground as the reference's example
(reference: blt_python/examples/basic_usage.py) — basic tokenization,
BPE merges, configuration — and then the capabilities the rebuild adds:
in-memory token values honored exactly, tokenize_bytes, hierarchical
rules, and learning merges from a corpus.
"""

import os
import sys
import tempfile

import numpy as np

# The examples demonstrate semantics on tiny inputs, where accelerator
# compile latency would dominate; pin JAX to CPU. Delete these two lines
# to run the device paths (see docs/DEPLOYMENT.md for real workloads).
import jax

jax.config.update("jax_platforms", "cpu")

try:
    import blt_tpu as blt
except ModuleNotFoundError:  # running from the source tree without install
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import blt_tpu as blt


def demo_basic():
    print("=== basic mode (each byte -> u16 big-endian) ===")
    tok = blt.ByteTokenizer()
    print(f"tokenizer: {tok}")
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in.txt"), os.path.join(d, "out.bin")
        with open(inp, "w") as f:
            f.write("hello world")
        tok.tokenize_file(inp, out)
        data = open(out, "rb").read()
        print(f"{os.path.getsize(inp)} bytes -> {len(data)} bytes")
        print(f"first 10 output bytes: {data[:10].hex(' ')}")


def demo_bpe_file():
    print("\n=== BPE from a merges file (reference grammar) ===")
    with tempfile.TemporaryDirectory() as d:
        merges_path = os.path.join(d, "merges.txt")
        with open(merges_path, "w") as f:
            f.write("# ab -> 256, cd -> 257\n97 98\n99 100\n")
        merges = blt.load_bpe_merges(merges_path)
        print(f"loaded merges: {merges}")
        tok = blt.ByteTokenizer(merges=merges)
        inp, out = os.path.join(d, "in.txt"), os.path.join(d, "out.bin")
        with open(inp, "w") as f:
            f.write("abcd abcd")
        tok.tokenize_file(inp, out)
        toks = np.frombuffer(open(out, "rb").read(), ">u2")
        print(f"'abcd abcd' -> {toks.tolist()}")
        # the inverse direction (extension: the reference cannot invert
        # its own output)
        back = os.path.join(d, "back.txt")
        tok.detokenize_file(out, back)
        print(f"decoded back: {open(back).read()!r}")


def demo_configs():
    print("\n=== configuration ===")
    for cfg in (
        {},
        {"content_type": "Text"},
        {"threads": 2, "chunk_size": "1MB", "memory_cap": 50},
        {"engine": "numpy"},
    ):
        print(blt.ByteTokenizer(**cfg))


def demo_in_memory_values():
    print("\n=== in-memory merges keep their token values (rebuild fix) ===")
    # The reference's Python binding silently rewrites dict values to
    # 256,257,... in hash order (blt_python/src/lib.rs:103-114); here the
    # values are honored exactly.
    tok = blt.ByteTokenizer(merges={(97, 98): 300})
    toks = tok.tokenize_bytes(b"abab")
    print(f"(97,98)->300 on 'abab': {toks.tolist()}")


def demo_hierarchical():
    print("\n=== hierarchical rules (multipass, in-memory only) ===")
    tok = blt.ByteTokenizer(merges={(97, 98): 256, (256, 99): 257})
    toks = tok.tokenize_bytes(b"abcabc")
    print(f"'abcabc' with ab->256, (256)c->257: {toks.tolist()}")


def demo_training():
    print("\n=== learning merges from a corpus (rebuild extension) ===")
    from blt_tpu.parallel.train import learn_bpe, save_merges

    corpus = b"the quick brown fox jumps over the lazy dog " * 50
    merges = learn_bpe(corpus, num_merges=8)
    print(f"learned: {merges}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "learned.txt")
        save_merges(merges, path)
        print(f"saved reference-grammar merges file ({path}):")
        print(open(path).read().rstrip())


def demo_server():
    print("\n=== HTTP service (the reference's unimplemented REST API) ===")
    import http.client
    import threading

    from blt_tpu.server import make_server

    srv = make_server(port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection(*srv.server_address, timeout=5)
    conn.request("POST", "/tokenize?type=text", body=b"hi")
    wire = conn.getresponse().read()
    conn.close()
    srv.shutdown()
    srv.server_close()
    print(f"POST /tokenize?type=text 'hi' -> {wire.hex(' ')}")


def main():
    print(f"blt_tpu version: {blt.version()}")
    demo_basic()
    demo_bpe_file()
    demo_configs()
    demo_in_memory_values()
    demo_hierarchical()
    demo_training()
    demo_server()
    print("\nall examples completed")


if __name__ == "__main__":
    main()
