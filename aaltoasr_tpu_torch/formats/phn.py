"""Transcription/alignment (.phn) files.

Host copy of `aaltoasr_tpu/formats/phn.py`.

Format (`aku/PhnReader.hh:13-26`)::

    [start_sample end_sample] label[.state] [comment ...]

* Sample numbers always refer to 16 kHz audio: ``frame = sample //
  samples_per_frame`` with ``samples_per_frame = 16000 / frame_rate``
  (`aku/PhnReader.cc` next_phn_line; set_frame_rate).
* A ``label.N`` suffix carries the HMM state number within the phone.
* Lines without a leading digit have no time fields (start = end = -1).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PhnEntry:
    start: int            # start sample (16 kHz convention), -1 if absent
    end: int              # first sample after the phone, -1 if absent
    label: str            # phone label (state suffix stripped)
    state: int = -1       # HMM state number from 'label.N', or -1
    comment: str = ""     # rest of the line

    def frame_span(self, samples_per_frame: float = 128.0) -> tuple[int, int]:
        """(start_frame, end_frame) using integer division like the reference."""
        return (int(self.start / samples_per_frame),
                int(self.end / samples_per_frame))


def parse_phn_line(line: str) -> PhnEntry | None:
    line = line.strip()
    if not line:
        return None
    start = end = -1
    state = -1
    if line[0].isdigit():
        fields = line.split(None, 3)
        if len(fields) < 3:
            raise ValueError(f"invalid phn line: {line!r}")
        start = int(fields[0])
        end = int(fields[1])
        label = fields[2]
        comment = fields[3] if len(fields) > 3 else ""
    else:
        fields = line.split(None, 1)
        label = fields[0]
        comment = fields[1] if len(fields) > 1 else ""
    if "." in label:
        base, _, suffix = label.partition(".")
        # reference: state = atoi(after '.'), erase 2 chars from '.' on
        try:
            state = int(suffix)
            label = base
        except ValueError:
            pass
    if start > end:
        raise ValueError(f"invalid start or end time: {line!r}")
    return PhnEntry(start=start, end=end, label=label, state=state,
                    comment=comment)


def read_phn(path) -> list[PhnEntry]:
    entries = []
    with open(path) as f:
        for line in f:
            e = parse_phn_line(line)
            if e is not None:
                entries.append(e)
    return entries


def write_phn(path, entries) -> None:
    """Write .phn lines; state >= 0 emits the 'label.N' form."""
    with open(path, "w") as f:
        for e in entries:
            label = e.label if e.state < 0 else f"{e.label}.{e.state}"
            parts = []
            if e.start >= 0:
                parts += [str(e.start), str(e.end)]
            parts.append(label)
            if e.comment:
                parts.append(e.comment)
            f.write(" ".join(parts) + "\n")
