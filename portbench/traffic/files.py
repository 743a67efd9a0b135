"""The task and model as the files the program reads.

AaltoASR's formats, written from plain data: NOWAY .ph topology,
.gk diagonal Gaussians, .mc mixtures, version-4 .dur gamma durations
(`aku/HmmSet.cc`, `aku/dur_est.cc`), a lexicon, an ARPA LM, a feature
configuration, 16-bit PCM WAVs, .phn transcripts and a recipe.
Floating-point parameters are written with 17 significant digits, so
the program reads the very numbers the reference uses.
"""

from __future__ import annotations

import math
import os
import wave

import numpy as np


def write_model(base: str, phones: dict, transitions: dict, means,
                covars, comp, weights, durations=None) -> dict:
    """``base``.ph/.gk/.mc[/.dur]; returns their paths."""
    with open(base + ".ph", "w") as f:
        f.write(f"PHONE\n{len(phones)}\n")
        for h, (label, states) in enumerate(phones.items()):
            ns = len(states)
            f.write(f"{h + 1} {ns + 2} {label}\n")
            f.write("-1 -2" + "".join(f" {s}" for s in states) + "\n")
            f.write("0 1 2 1\n1 0\n")
            for i, s in enumerate(states):
                trans = transitions[s]
                parts = [str(i + 2), str(len(trans))]
                for offset, prob in trans:
                    target = offset + 2 + i
                    parts += [str(1 if target == ns + 2 else target),
                              repr(float(prob))]
                f.write(" ".join(parts) + "\n")
    means = np.asarray(means, np.float64)
    G, D = means.shape
    with open(base + ".gk", "w") as f:
        f.write(f"{G} {D} diagonal_cov\n")
        np.savetxt(f, np.concatenate([means, np.asarray(covars)], axis=1),
                   fmt="%.17g")
    comp = np.asarray(comp)
    weights = np.asarray(weights, np.float64)
    with open(base + ".mc", "w") as f:
        f.write(f"{comp.shape[0]}\n")
        for idx, w in zip(comp, weights):
            f.write(" ".join([str(len(idx))] + [f"{int(i)} {float(x)!r}"
                                                for i, x in zip(idx, w)])
                    + "\n")
    paths = {"am": base, "ph": base + ".ph"}
    if durations is not None:
        with open(base + ".dur", "w") as f:
            f.write(f"4\n{len(durations)}\n")
            for i, (a, b) in enumerate(durations):
                f.write(f"{i} {a:.4f} {b:.4f}\n")
        paths["dur"] = base + ".dur"
    return paths


def write_arpa(path: str, vocab: list, ngrams: dict) -> None:
    """ARPA text of natural-log n-grams {order: {ids: (lp, bo)}}."""
    ln10 = math.log(10.0)
    with open(path, "w") as f:
        f.write("\\data\\\n")
        for o in sorted(ngrams):
            f.write(f"ngram {o}={len(ngrams[o])}\n")
        for o in sorted(ngrams):
            f.write(f"\n\\{o}-grams:\n")
            for ids, (lp, bo) in sorted(ngrams[o].items()):
                ws = " ".join(vocab[w] for w in ids)
                if bo != 0.0:
                    f.write(f"{lp / ln10:.6f} {ws} {bo / ln10:.6f}\n")
                else:
                    f.write(f"{lp / ln10:.6f} {ws}\n")
        f.write("\n\\end\\\n")


def write_text(path: str, text: str) -> str:
    with open(path, "w") as f:
        f.write(text)
    return path


def write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Mono 16-bit PCM; ``samples`` already hold 16-bit values."""
    pcm = np.asarray(samples).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def write_recipe(directory: str, name: str, samples: list,
                 transcripts: list) -> str:
    """WAVs and label-only .phn transcripts under ``directory``, and a
    recipe ``name`` naming them; returns the recipe's path."""
    os.makedirs(directory, exist_ok=True)
    lines = []
    for u, (s, labels) in enumerate(zip(samples, transcripts)):
        wav = os.path.join(directory, f"{name}_{u}.wav")
        phn = os.path.join(directory, f"{name}_{u}.phn")
        write_wav(wav, s)
        write_text(phn, "\n".join(labels) + "\n")
        lines.append(f"audio={wav} transcript={phn} utterance={name}_{u}")
    return write_text(os.path.join(directory, f"{name}.recipe"),
                      "\n".join(lines) + "\n")
