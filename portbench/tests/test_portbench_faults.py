"""A run with its timed path broken underneath comes out not correct:
the look for a chip skipped, the rest of a run driven on the CPU at a
tiny size, once for each fault a cell can have (one chip: no exchange
between chips to leave out)."""

import json

import pytest
import torch

from portbench import run
from portbench.control import altered
from portbench.tests.tiny import tiny_spec


def result(name, capsys, spec=None):
    seconds = "4" if name == "xw1k.stream" else "0.5"
    rc = run.main(["--workload", name, "--seed", "3000000001", "--seconds",
                   seconds, "--trace", "0"], device=torch.device("cpu"),
                  spec=spec or tiny_spec(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def shifted_log_probs(monkeypatch):
    """Every LNA log-prob 0.01 lower where it is produced (18 code
    steps)."""
    from aaltoasr_tpu_torch.ops.gmm import GmmScorer
    orig = GmmScorer.lna_log_probs
    monkeypatch.setattr(GmmScorer, "lna_log_probs",
                        lambda self, f: orig(self, f) - 0.01)


def altered_words(results):
    for r in results:
        r._words = altered(r.words)
    return results


FAULTS = {
    "xw1k.dense-b128": ["words", "half_batch", "log_probs"],
    "xw1k.stream": ["words", "log_probs"],
    "gmm10k.estep-b8": ["half_batch", "unchanged", "answer", "moments",
                        "occupancy"],
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


def plant(name, fault, monkeypatch):
    if fault == "log_probs":
        shifted_log_probs(monkeypatch)
    elif name == "xw1k.dense-b128":
        from aaltoasr_tpu_torch.decoder.search_dense import DenseBeamSearch
        orig = DenseBeamSearch.decode_batch
        if fault == "words":
            monkeypatch.setattr(DenseBeamSearch, "decode_batch",
                                lambda s, *a, **k: altered_words(
                                    orig(s, *a, **k)))
        else:
            monkeypatch.setattr(DenseBeamSearch, "decode_batch",
                                lambda s, obs, n, *a, **k: orig(
                                    s, obs[:len(n) // 2], n[:len(n) // 2],
                                    *a, **k))
    elif name == "xw1k.stream":
        from aaltoasr_tpu_torch.decoder.search import StreamingDecoder
        orig = StreamingDecoder.result
        monkeypatch.setattr(StreamingDecoder, "result",
                            lambda s: altered_words([orig(s)])[0])
    else:
        from aaltoasr_tpu_torch.train.driver import EStepDriver
        if fault == "half_batch":
            orig = EStepDriver._run_batch

            def half(self, *a, **k):
                out = orig(self, *a, **k)
                B = len(out["log_likelihood"])
                for v in out.values():
                    v[B // 2:] = v[:B - B // 2]   # the kept half, repeated
                return out
            monkeypatch.setattr(EStepDriver, "_run_batch", half)
        elif fault == "unchanged":
            from aaltoasr_tpu_torch.train.accumulators import HmmStats
            monkeypatch.setattr(
                EStepDriver, "run_recipe_batched",
                lambda self, recipe, **k: HmmStats.zeros(self.model,
                                                         self.table))
        else:
            # answer: one utterance's log-likelihood and moments 1% off;
            # moments, occupancy: every utterance's moment sums or
            # occupancies counted twice, its log-likelihood unchanged
            keys = {"answer": ("log_likelihood", "mean_acc"),
                    "moments": ("mean_acc", "sec_acc"),
                    "occupancy": ("gamma", "mix_gamma")}[fault]
            scale = 1.01 if fault == "answer" else 2.0
            rows = slice(0, 1) if fault == "answer" else slice(None)
            orig = EStepDriver._run_batch

            def altered(self, *a, **k):
                out = orig(self, *a, **k)
                for key in keys:
                    out[key][rows] *= scale
                return out
            monkeypatch.setattr(EStepDriver, "_run_batch", altered)


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, capsys, monkeypatch):
    sound = result(name, capsys)
    plant(name, fault, monkeypatch)
    broken = result(name, capsys)
    assert broken["correct"] is False
    worse = [k for k, c in broken["checks"].items()
             if c["value"] > c["limit"] and c["value"] > sound["checks"][k]["value"]]
    assert worse, (sound["checks"], broken["checks"])
