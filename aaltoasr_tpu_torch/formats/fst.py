"""MIT-FST ASCII format: the hmmnet training-network interchange.

Host copy of `aaltoasr_tpu/formats/fst.py`.

Reference reader: `aku/HmmNetBaumWelch.cc:65-160` read_fst.  Lines::

    I <node>                  initial node
    F <node>                  final node
    T <src> <tgt> [in [out [score]]]

* ``in`` is ``transition_index[;logical;...]`` (the index into the
  model's global transition numbering = our TransitionTable slots), or
  ``#label`` / ``,`` (epsilon), where ',' is the epsilon string.
* ``out`` is a word/phone label; ``score`` an optional static log-score.
* Node ids must form a contiguous range.
"""

from __future__ import annotations

from dataclasses import dataclass, field


EPSILON = -1


@dataclass
class FstArc:
    source: int
    target: int
    transition_index: int = EPSILON   # model transition slot, or EPSILON
    label: str = ""                   # logical label (word/phone)
    out_label: str = ""
    score: float = 0.0                # static log score
    inst: int = -1                    # first-level logical arc (phone
                                      # instance) id; -1 = unknown
    word_inst: int = -1               # word instance id (-1 = unknown)


@dataclass
class Fst:
    initial: int = -1
    final: int = -1
    num_nodes: int = 0
    arcs: list = field(default_factory=list)
    word_names: list = field(default_factory=list)  # word_inst -> label

    def add_arc(self, arc: FstArc) -> None:
        self.num_nodes = max(self.num_nodes, arc.source + 1,
                             arc.target + 1)
        self.arcs.append(arc)


def parse_fst(text: str, epsilon_string: str = ",") -> Fst:
    fst = Fst()
    for line in text.splitlines():
        fields = line.split()
        if not fields:
            continue
        if fields[0] == "#FSTBinary":
            raise ValueError("FSTBinary format not supported")
        if fields[0] == "I":
            if fst.initial != -1:
                raise ValueError(f"Initial node redefined: {line}")
            fst.initial = int(fields[1])
            fst.num_nodes = max(fst.num_nodes, fst.initial + 1)
        elif fields[0] == "F":
            if fst.final != -1:
                raise ValueError(f"Final node redefined: {line}")
            fst.final = int(fields[1])
            fst.num_nodes = max(fst.num_nodes, fst.final + 1)
        elif fields[0] == "T":
            src, tgt = int(fields[1]), int(fields[2])
            tr_index = EPSILON
            label = ""
            out_label = ""
            score = 0.0
            if len(fields) > 3:
                in_label = fields[3]
                if in_label != epsilon_string:
                    if in_label.startswith("#"):
                        label = in_label[1:]
                    else:
                        first = in_label.split(";")[0]
                        try:
                            tr_index = int(first)
                            parts = in_label.split(";")
                            if len(parts) > 1:
                                label = parts[1]
                        except ValueError:
                            # symbolic input label (lex2fst/hmm-level FSTs)
                            label = in_label
                if (in_label and not in_label.startswith("#")
                        and len(fields) > 4):
                    if fields[4] != epsilon_string:
                        out_label = fields[4]
                if len(fields) > 5:
                    score = float(fields[5])
            fst.add_arc(FstArc(src, tgt, tr_index, label, out_label,
                               score))
    if fst.initial < 0:
        raise ValueError("initial node not specified")
    if fst.final < 0:
        raise ValueError("final node not specified")
    return fst


def read_fst(path) -> Fst:
    with open(path) as f:
        return parse_fst(f.read())


def write_fst(fst: Fst, path_or_file,
              epsilon_string: str = ",") -> None:
    """Write MIT-FST ASCII (create_hmmnets.pl output format)."""
    import io
    own = not hasattr(path_or_file, "write")
    f = open(path_or_file, "w") if own else path_or_file
    try:
        f.write(f"I {fst.initial}\n")
        f.write(f"F {fst.final}\n")
        for a in fst.arcs:
            if a.transition_index == EPSILON:
                if a.label and a.out_label:
                    in_label = a.label        # symbolic label arc
                elif a.label:
                    in_label = f"#{a.label}"
                else:
                    in_label = epsilon_string
            else:
                in_label = str(a.transition_index)
                if a.label:
                    in_label += f";{a.label}"
            out = a.out_label if a.out_label else epsilon_string
            if a.score != 0.0:
                f.write(f"T {a.source} {a.target} {in_label} {out} "
                        f"{a.score:.6f}\n")
            else:
                f.write(f"T {a.source} {a.target} {in_label} {out}\n")
    finally:
        if own:
            f.close()
