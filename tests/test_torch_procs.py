"""The port's copy of the wedge-proof subprocess helper
(streamz_tpu_torch/runtime/procs.py), held to tests/test_procs.py's cases."""

import sys

from streamz_tpu_torch.runtime.procs import probe_ok, run_abandonable


def test_run_abandonable_success_captures_output():
    rc, timed_out, out, err = run_abandonable(
        [sys.executable, "-c", "import sys; print('hi'); print('oops', file=sys.stderr)"],
        timeout=60, capture=True,
    )
    assert rc == 0 and not timed_out
    assert out.strip() == "hi" and err.strip() == "oops"


def test_run_abandonable_timeout_kills_and_flags():
    rc, timed_out, out, err = run_abandonable(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        timeout=1, capture=True,
    )
    assert rc is None and timed_out


def test_run_abandonable_invalid_utf8_does_not_raise():
    rc, timed_out, out, err = run_abandonable(
        [sys.executable, "-c",
         "import sys; sys.stdout.buffer.write(b'\\xff\\xfe broken \\xff')"],
        timeout=60, capture=True,
    )
    assert rc == 0 and "broken" in out  # errors='replace', no crash


def test_run_abandonable_spawn_failure():
    rc, timed_out, out, err = run_abandonable(
        ["/no/such/interpreter"], timeout=5, capture=True,
    )
    assert rc is None and not timed_out and "spawn failed" in err


def test_probe_ok_true_and_false():
    assert probe_ok("import sys; sys.exit(0)", timeout=60)
    assert not probe_ok("import sys; sys.exit(3)", timeout=60)
    assert not probe_ok("import time; time.sleep(60)", timeout=1)
