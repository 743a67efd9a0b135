"""Class-based LM support (`decoder/src/WordClasses.{hh,cc}`).

Host copy of `aaltoasr_tpu/decoder/classes.py`.  Class definition file:
``class_name [probability] word`` per line.  In decoding, a word's LM
identity becomes its class and its in-class membership log-prob joins
the pronunciation score: P(w | h) = P(class(w) | h) * p(w | class(w)).

The reference's `apply_to_tree` adds the membership log-probs to the
tree's pronunciation scores in place, so a second search built on the
same tree adds them again.  Here `pron_logp` returns the adjusted scores
as a new array and the tree stays as it was read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class WordClasses:
    # word -> (class_name, ln membership prob)
    membership: dict = field(default_factory=dict)

    @classmethod
    def read(cls, path_or_text) -> "WordClasses":
        text = path_or_text
        if "\n" not in str(text):
            with open(text) as f:
                text = f.read()
        out = cls()
        for line in text.splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) == 2:
                class_name, word = parts
                prob = 1.0
            elif len(parts) >= 3:
                class_name = parts[0]
                try:
                    prob = float(parts[1])
                    word = parts[2]
                except ValueError:
                    prob = 1.0
                    word = parts[1]
            else:
                continue
            out.membership[word] = (
                class_name, math.log(prob) if prob > 0 else -1e30)
        return out

    def pron_logp(self, tree) -> np.ndarray:
        """The tree's [N, H] word-end pronunciation scores plus each
        class member's membership log-prob (LM side, like cm_log_prob),
        added in the reference's order: float32 += python float."""
        pron = np.array(tree.we_pron_logp)
        for n in range(tree.we_word.shape[0]):
            for h in range(tree.we_word.shape[1]):
                w = int(tree.we_word[n, h])
                if w < 0:
                    continue
                word = tree.vocab[w]
                if word in self.membership:
                    pron[n, h] += self.membership[word][1]
        return pron

    def lm_word_names(self, vocab) -> list:
        """Per tree-vocab word: the LM symbol to query (class or word)."""
        return [self.membership.get(w, (w, 0.0))[0] for w in vocab]
