"""The port's entry points of ``streamz_tpu_torch/entry.py``, on the CPU.

``dryrun_multichip(n, device="cpu")`` for n = 2 and 3: every one of the
five programs of ``__graft_entry__.py:166-385`` reports ``ok`` on its
printed line and in the returned results; a program made to fail is named
in the ``RuntimeError`` while the others still report ``ok``.  ``entry()``'s
vote sums lie within 1e-4 of the JAX ``entry()``'s ``fn`` on the same
inputs (the frontend's 1e-4 against the XLA formulation,
``tests/test_torch_mfcc.py``).
"""

import numpy as np
import pytest
import torch

from streamz_tpu_torch import entry as tentry


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip_runs_every_program(n, capsys):
    results = tentry.dryrun_multichip(n, device="cpu")
    assert results == {name: "ok" for name in tentry.PROGRAMS}
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("multichip programs:")]
    assert line == ["multichip programs: " + " ".join(f"{p}=ok" for p in tentry.PROGRAMS)]


def test_dryrun_multichip_names_a_failed_program(monkeypatch, capsys):
    def broken(n, device):
        raise AssertionError("made to fail")

    monkeypatch.setattr(tentry, "_prog_serve_shard", broken)
    with pytest.raises(RuntimeError, match=r"\['serve_shard'\]") as err:
        tentry.dryrun_multichip(2, device="cpu")
    assert "made to fail" in str(err.value)
    out = capsys.readouterr().out
    assert "serve_shard=FAIL" in out and "dp_train=ok" in out and "identify_psum=ok" in out


def test_entry_vote_sums_match_jax_entry():
    from __graft_entry__ import entry as jentry

    jfn, jargs = jentry()
    want = np.asarray(jfn(*jargs))
    fn, args = tentry.entry(device="cpu")
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    with torch.no_grad():
        got = fn(*args).numpy()
    assert got.shape == want.shape == (4, 128)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[:, :4].sum() > 0 and not got[:, 4:].any()
