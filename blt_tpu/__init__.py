"""blt_tpu — byte-level tokenization framework on JAX accelerators.

A from-scratch JAX/XLA rebuild with the capabilities and bit-exact
output semantics of the reference Rust tokenizer (jtrefon/blt): three modes
(basic byte->u16, pass-based greedy BPE, passthrough), content-type header
tokens, streaming of arbitrarily large inputs under a memory cap, a CLI, and
this Python API.

Public surface mirrors the reference's Python package
(reference: blt_python/python/blt/__init__.py:12-16):

    >>> import blt_tpu as blt
    >>> tok = blt.ByteTokenizer()
    >>> tok.tokenize_file("input.txt", "output.bin")
"""

from blt_tpu._version import __version__, version
from blt_tpu.api import ByteTokenizer
from blt_tpu.config import ContentType, CoreConfig, Engine, Mode
from blt_tpu.merges import MergeTable, load_bpe_merges, load_bpe_merges_from_path
from blt_tpu.pipeline.runner import run_tokenizer

__all__ = [
    "ByteTokenizer",
    "load_bpe_merges",
    "load_bpe_merges_from_path",
    "version",
    "__version__",
    "CoreConfig",
    "ContentType",
    "Engine",
    "Mode",
    "MergeTable",
    "run_tokenizer",
]
