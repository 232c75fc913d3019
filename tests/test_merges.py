"""Merges-loader tests (mirror blt_core/src/config_loader.rs:50-203)."""

import pytest

from blt_tpu.merges import (
    MergesFormatError,
    MergeTable,
    load_bpe_merges,
    load_bpe_merges_from_path,
    parse_merges_text,
)


def write(tmp_path, text):
    p = tmp_path / "merges.txt"
    p.write_text(text)
    return p


def test_load_valid(tmp_path):
    p = write(tmp_path, "97 98\n99 100\n# this is a comment\n101 102\n")
    merges = load_bpe_merges_from_path(p)
    assert merges == {(97, 98): 256, (99, 100): 257, (101, 102): 258}


def test_load_empty_file(tmp_path):
    p = write(tmp_path, "")
    assert load_bpe_merges_from_path(p) == {}


def test_only_comments_or_empty_lines(tmp_path):
    p = write(tmp_path, "# comment 1\n\n# comment 2\n")
    assert load_bpe_merges_from_path(p) == {}


def test_invalid_not_enough_parts(tmp_path):
    p = write(tmp_path, "97\n")
    with pytest.raises(MergesFormatError, match="Invalid merge rule format"):
        load_bpe_merges_from_path(p)


def test_invalid_too_many_parts(tmp_path):
    p = write(tmp_path, "97 98 99\n")
    with pytest.raises(MergesFormatError, match="Invalid merge rule format"):
        load_bpe_merges_from_path(p)


def test_invalid_byte_value_nan(tmp_path):
    p = write(tmp_path, "97 abc\n")
    with pytest.raises(
        MergesFormatError, match="Failed to parse second byte value"
    ):
        load_bpe_merges_from_path(p)


def test_invalid_byte_value_overflow(tmp_path):
    p = write(tmp_path, "256 98\n")
    with pytest.raises(
        MergesFormatError, match="Failed to parse first byte value"
    ):
        load_bpe_merges_from_path(p)


def test_file_not_found():
    with pytest.raises(FileNotFoundError):
        load_bpe_merges_from_path("this_file_should_not_exist.txt")


def test_vocab_size_increment_duplicates():
    # ids increment per valid line even for duplicate pairs; last line wins
    # (config_loader.rs:167-202).
    merges = parse_merges_text("1 2\n3 4\n1 2\n5 6\n")
    assert merges == {(1, 2): 258, (3, 4): 257, (5, 6): 259}
    assert len(merges) == 3


def test_whitespace_only_line_is_error():
    # Rust's line.is_empty() is false for "  ", so it hits the format error.
    with pytest.raises(MergesFormatError, match="Invalid merge rule format"):
        parse_merges_text("  \n")


def test_load_bpe_merges_public(tmp_path):
    p = write(tmp_path, "97 98\n99 100\n")
    merges = load_bpe_merges(p)
    assert merges == {(97, 98): 256, (99, 100): 257}


def test_merge_table_flat_classification():
    # file-style: keys < 256, values >= 256 => flat
    assert MergeTable.build({(97, 98): 256, (99, 100): 257}).flat
    # empty table is trivially flat
    assert MergeTable.build({}).flat
    # hierarchical rule: key member >= 256 => not flat
    assert not MergeTable.build({(97, 98): 256, (256, 99): 257}).flat
    # value collides with a key member => not flat
    assert not MergeTable.build({(120, 121): 90, (90, 122): 256}).flat
    # value < 256 but never a key member => still flat
    assert MergeTable.build({(120, 121): 90}).flat
