"""Word errors of a recognized word sequence against the planted one."""

from __future__ import annotations


def content_words(words) -> list:
    """Words without silences and sentence markers."""
    return [w for w in words if not w.startswith(("_", "<s>", "</s>"))]


def edit_distance(a: list, b: list) -> int:
    """Levenshtein distance between two word lists."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def word_errors(hyps: list, truths: list) -> tuple[int, int]:
    """(errors, planted words) summed over utterances; ``truths`` are
    planted word strings."""
    errs = sum(edit_distance(content_words(h), t) for h, t in zip(hyps, truths))
    return errs, sum(len(t) for t in truths)
