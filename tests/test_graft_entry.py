"""Driver entry-point tests: entry() compiles, dryrun runs on the mesh."""

import jax
import pytest

import __graft_entry__ as graft


def test_entry_compiles():
    fn, args = graft.entry()
    # lower+compile on the test backend without executing
    lowered = jax.jit(fn).lower(*args)
    assert lowered.compile() is not None


def test_dryrun_multichip_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    graft.dryrun_multichip(8)


def test_dryrun_multichip_fails_without_enough_devices(monkeypatch):
    """Too few devices and no virtual-mesh flag: fail, never fall back to
    CPU devices behind the caller's back."""
    monkeypatch.setenv("XLA_FLAGS", "")
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        graft.dryrun_multichip(64)
