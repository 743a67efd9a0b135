"""Morph-set letter trie + text->morph-lattice segmentation.

Reference-parity implementation of the `morph_lattice` tool
(`tools/morph_lattice/MorphSet.{hh,cc}`: letter-tree of morphs with
the complete morph stored on the final arc;
`tools/morph_lattice/Latticer.cc:13-92`: stream the text corpus and
emit every morph path as ``src tgt morph`` arcs, one node per text
character plus one per collapsed whitespace run, terminated by the
highest node id).  The output lattice feeds morph-LM training /
rescoring; this is byte-compatible with the reference binary
(verified in ``tests/test_golden_morph_lattice.py``).

Host-side text processing — no device work.
"""

from __future__ import annotations

from typing import Dict, Optional, TextIO, Tuple

_WHITESPACE = " \n\r\t"

# trie node: letter -> (complete-morph-or-empty, child node)
_Node = Dict[str, Tuple[str, "dict"]]


class MorphSet:
    """Letter tree of morphs (`MorphSet.hh:6-63`).

    Arcs carry one character; an arc whose path spells a complete
    morph stores that morph on the arc (`MorphSet.cc:8-41` insert).
    """

    def __init__(self) -> None:
        self.root: _Node = {}
        self.max_morph_length = 0

    def insert(self, morph: str) -> None:
        """Insert one morph (`MorphSet.cc:55-70` read loop body).

        Redefining an existing morph is an error, matching the
        reference's hard exit (`MorphSet.cc:26-33`).
        """
        node = self.root
        last = len(morph) - 1
        for i, letter in enumerate(morph):
            arc = node.get(letter)
            if arc is None:
                arc = ("" if i < last else morph, {})
                node[letter] = arc
            elif i == last:
                if arc[0]:
                    raise ValueError(
                        f"trying to redefine morph {morph}")
                node[letter] = arc = (morph, arc[1])
            node = arc[1]
        if len(morph) > self.max_morph_length:
            self.max_morph_length = len(morph)

    @classmethod
    def read(cls, text: str) -> "MorphSet":
        """One morph per line; blank lines skipped; edges stripped of
        `` \\t\\r\\n`` (`MorphSet.cc:55-70`)."""
        ms = cls()
        for line in text.split("\n"):
            line = line.strip(_WHITESPACE)
            if line:
                ms.insert(line)
        return ms


def create_lattice(morph_set: MorphSet, text: str, out: TextIO,
                   word_boundary: str = "<w>") -> None:
    """Emit the lattice of ALL morph paths through ``text``
    (`Latticer.cc:13-92`).

    Node numbering: node 0 is a virtual start; an initial word
    boundary arc ``0 1 <w>`` is always emitted; thereafter one node
    per text character, except whitespace runs which collapse to a
    single boundary arc.  A trailing space is implied at end of
    input (`Latticer.cc:34-39` appends " " on EOF), so the lattice
    always closes with a word boundary unless the text already ended
    in whitespace.  The final line is the highest node id reached.
    """
    out.write(f"0 1 {word_boundary}\n")
    buf = text + " "                     # EOF space, Latticer.cc:38
    src = 1
    last = 0
    was_wb = False
    n = len(buf)
    root = morph_set.root
    for i in range(n):
        ch = buf[i]
        if ch in _WHITESPACE:
            # collapse runs: only the first whitespace advances the
            # node counter and emits an arc (Latticer.cc:48-60)
            if not was_wb:
                out.write(f"{src} {src + 1} {word_boundary}\n")
                src += 1
                if src > last:
                    last = src
            was_wb = True
            continue
        was_wb = False
        # walk the letter tree from this character, emitting every
        # complete morph found along the way (Latticer.cc:64-82)
        node = root
        pos = i
        while pos < n:
            arc = node.get(buf[pos])
            if arc is None:
                break
            morph, node = arc
            pos += 1
            if morph:
                tgt = src + (pos - i)
                out.write(f"{src} {tgt} {morph}\n")
                if tgt > last:
                    last = tgt
        src += 1
    out.write(f"{last}\n")
