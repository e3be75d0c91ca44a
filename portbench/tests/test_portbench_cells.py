"""Each driver end to end on the CPU at a tiny size, with the program on
its plain CPU path: the check passes; and with a fault planted in the
timed path underneath, the same run reads ``correct`` false.  These runs
skip the harness's look for a card (``run.py`` refuses to run without
one) and nothing else."""

import copy

import pytest

from portbench import harness

TINY = {
    "ref8-train": ({"speakers": 2, "corpus": {"clips_per_speaker": 4,
                                              "labelled_per_speaker": 2, "clip_seconds": 1}},
                   {}),
    "ref8-identify": ({"speakers": 3, "identify": {"pool": 8, "batch": 4, "clip_seconds": 1},
                       "enroll": {"clips_per_speaker": 2, "seconds": 1, "rate": 44100}}, {}),
    "vox1251-identify": ({"speakers": 5, "identify": {"pool": 8, "batch": 4},
                          "enroll": {"clips_per_speaker": 2, "seconds": 1, "rate": 44100},
                          "utterance_mean_s": 1.5, "utterance_min_s": 1.0,
                          "utterance_max_s": 2.5}, {}),
}
SEED = 2**31 + 12345


def tiny(name):
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.workload = copy.deepcopy(cell.workload)
    conf, wl = TINY[name]
    cell.config.update(conf)
    cell.workload.update(wl)
    return cell


def run(name, tmp_path, monkeypatch, seconds=1.0):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    result, checks = harness.run_cell(tiny(name), SEED, seconds, False, "cpu")
    return result, dict((n, v) for n, v, _ in checks)


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(name, tmp_path, monkeypatch):
    result, checks = run(name, tmp_path, monkeypatch)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {m["name"] for m in tiny(name).end_to_end} == set(result["metrics"])


def _unchanged_step(monkeypatch):
    """K6's file training returns the parameters as they came."""
    import torch
    from streamz_tpu_torch.nn import train

    def step(params, chunks, masks, target_vec, num_speakers, lr):
        z = torch.zeros((), device=chunks.device)
        return z, z
    monkeypatch.setattr(train, "train_windows_k6", step)


def _half_batch(monkeypatch):
    """The corpus step sees half of its rows, the mean over the rest."""
    from streamz_tpu_torch.app import corpus
    from streamz_tpu_torch.nn.train_kernels import PoolRows

    step = corpus.corpus_step_k5

    def half(params, rows, ns, lr):
        k = rows.n // 2
        return step(params, PoolRows(rows.pool_x, rows.pool_y, rows.order[:k],
                                     None if rows.keep is None else rows.keep[:k], k), ns, lr)
    monkeypatch.setattr(corpus, "corpus_step_k5", half)


def _altered_label(monkeypatch):
    """The written list gives the last file another speaker."""
    from streamz_tpu_torch.io import filelists

    write = filelists.write_train_files

    def altered(path, entries):
        entries = list(entries)
        p, c = entries[-1]
        entries[-1] = (p, (c or 0) + 1)
        return write(path, entries)
    monkeypatch.setattr(filelists, "write_train_files", altered)


def _altered_verdict(monkeypatch):
    """Every verdict names the speaker after the gate's choice."""
    from streamz_tpu_torch import cli

    gate = cli.identify_sims_cosine

    def altered(sims, stats, threshold):
        sid = gate(sims, stats, threshold)
        return (0 if sid is None else (sid + 1) % len(stats))
    monkeypatch.setattr(cli, "identify_sims_cosine", altered)


def _half_windows(monkeypatch):
    """Each clip's embedding is the mean over the first half of its windows."""
    from streamz_tpu_torch.infer import embed

    pooled = embed._fembed_mean_batch
    monkeypatch.setattr(embed, "_fembed_mean_batch",
                        lambda params, windows, n_valid: pooled(params, windows,
                                                                (n_valid + 1) // 2))


@pytest.mark.parametrize("name,fault", [
    ("ref8-train", _unchanged_step), ("ref8-train", _half_batch),
    ("ref8-train", _altered_label), ("ref8-identify", _altered_verdict),
    ("vox1251-identify", _half_windows),
])
def test_a_planted_fault_reads_incorrect(name, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result, checks = run(name, tmp_path, monkeypatch)
    assert not result["correct"], checks

