"""The check that decides ``correct``, driven through a whole run of a tiny
cell on the CPU (the look for a card skipped): sound, it passes; with the
timed path broken underneath, or with the control in the program's place,
it comes out false.

The tiny cell's limits are its own, set the way the real cells' are: at
this size (float32 on the CPU) the sound program reads 0 on every number,
and the control reads logit gaps of 6e-3 to 5e-2 (bf16 configuration,
float8 control) and 1.4 to 1.6 (int8 configuration, int4 control), so the
tiny limit on the logit gap is 1e-3.
"""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.registry import find_cell
from portbench.tests.tiny import write_root

SEED = 2**31 + 12345


def _run(tmp_path, weights="bf16", control=None, seed=SEED):
    cell = find_cell(write_root(str(tmp_path), weights=weights), root=str(tmp_path))
    return run.run_cell(cell, seed, 2.0, trace=False, device="cpu",
                        out_dir=str(tmp_path / "out"), control=control)


@pytest.mark.parametrize("seed", [1, SEED])
def test_sound_run_is_correct(tmp_path, seed):
    res = _run(tmp_path, seed=seed)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("weights,bits,seed", [
    ("bf16", "fp8", 1), ("bf16", "fp8", 2), ("bf16", "fp8", SEED), ("int8", 4, SEED)])
def test_the_control_in_the_programs_place_is_not_correct(tmp_path, weights, bits, seed):
    """The control's tokens and rows, judged by the verdict and the limits
    that judge the program's, come out not correct."""
    res = _run(tmp_path, weights=weights, control=bits, seed=seed)
    assert res["correct"], res["checks"]
    ctl = res["_control"]
    assert ctl["bits"] == bits and ctl["correct"] is False
    gap = ctl["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"], ctl["checks"]


def _paged_state_unchanged(monkeypatch):
    """A decode step whose K/V writes never reach the pool."""
    from docqa_tpu_torch.engines import serve

    real = serve.paged_decode_forward

    def forward(params, cfg, pools, *a, **k):
        return real(params, cfg, {n: t.clone() for n, t in pools.items()}, *a, **k)

    monkeypatch.setattr(serve, "paged_decode_forward", forward)


def _half_the_batch(monkeypatch):
    """Half of the lanes of every decode step left out (zero logits)."""
    from docqa_tpu_torch.engines import serve

    real = serve.paged_decode_forward

    def forward(*a, **k):
        out = real(*a, **k)
        out[out.shape[0] // 2:] = 0
        out[: out.shape[0] // 2] = out[: out.shape[0] // 2] * 2
        return out

    monkeypatch.setattr(serve, "paged_decode_forward", forward)


def _token_altered(monkeypatch):
    """Every verified token altered where it is produced."""
    from docqa_tpu_torch.engines import serve

    real = serve.accept_drafts

    def accept(logits, drafts, eos_id):
        g, m, cand, is_eos, eos_pos = real(logits, drafts, eos_id)
        g = (g + 1) % logits.shape[-1]
        return g, m, cand, is_eos & False, torch.full_like(eos_pos, g.shape[1])

    monkeypatch.setattr(serve, "accept_drafts", accept)


def _wrong_rows(monkeypatch):
    """Retrieval hands back the row after each one it found."""
    from docqa_tpu_torch.index.store import VectorStore

    real = VectorStore.search_rows

    def search_rows(self, buf, q, count, k, mask):
        vals, ids = real(self, buf, q, count, k, mask)
        return vals, (ids + 1) % count

    monkeypatch.setattr(VectorStore, "search_rows", search_rows)


def _prompt_altered(monkeypatch):
    """The prompt built with another template."""
    from docqa_tpu_torch.service import qa

    monkeypatch.setattr(qa, "QA_TEMPLATE", qa.QA_TEMPLATE.replace("Réponse", "Reponse"))


@pytest.mark.parametrize("fault,number", [
    (_paged_state_unchanged, "logit_gap"),
    (_half_the_batch, "logit_gap"),
    (_token_altered, "logit_gap"),
    (_wrong_rows, "retrieval_gap"),
    (_prompt_altered, "prompt_mismatch"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault, number):
    fault(monkeypatch)
    res = _run(tmp_path)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
