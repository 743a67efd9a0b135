"""Speaker configuration (.spkc) files.

Per-speaker / per-utterance runtime parameters for feature and model
modules (VTLN warp factors, MLLR/CMLLR transforms, CMVN stats).  Format
(`aku/SpeakerConfig.cc:20-155` read, `:157-230` write)::

    speaker <id|default>
    {
      [feature|model] <module_name>
      {
        <key> <value...>
      }
      ...
    }
    utterance <id|default>
    { ... }

A module line without a namespace defaults to the ``feature`` namespace.
Keys inside module blocks follow the ModuleConfig grammar.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from aaltoasr_tpu_torch.formats.feaconf import ModuleConfig


@dataclass
class SpeakerConfig:
    """Parsed .spkc: maps id -> {(namespace, module_name) -> ModuleConfig}."""

    speakers: dict = field(default_factory=dict)
    utterances: dict = field(default_factory=dict)
    default_speaker: dict | None = None
    default_utterance: dict | None = None

    # -- parsing ----------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "SpeakerConfig":
        lines = text.splitlines()
        pos = 0
        n = len(lines)
        out = cls()

        def next_line():
            nonlocal pos
            while pos < n:
                line = lines[pos].strip(" \t")
                pos += 1
                if line:
                    return line
            return None

        while True:
            line = next_line()
            if line is None:
                break
            fields = line.split()
            if len(fields) != 2 or fields[0] not in ("speaker", "utterance"):
                raise ValueError(f"SpeakerConfig: syntax error: {line}")
            kind, ident = fields
            is_default = ident == "default"
            modules: dict = {}

            line = next_line()
            if line != "{":
                raise ValueError(f"'{{' expected in speaker config file: {line}")
            while True:
                line = next_line()
                if line is None:
                    raise ValueError("unexpected end of speaker config file")
                if line == "}":
                    break
                parts = line.split(None, 1)
                if len(parts) < 2:
                    namespace, module = "feature", parts[0]
                else:
                    namespace, module = parts
                    if namespace not in ("feature", "model"):
                        raise ValueError(
                            f"SpeakerConfig: unknown module namespace: {line}")
                # read the { ... } module block
                cfg = ModuleConfig()
                line = next_line()
                if line != "{":
                    raise ValueError(f"'{{' expected: {line}")
                while True:
                    line = next_line()
                    if line is None:
                        raise ValueError("unexpected end of module config")
                    if line == "}":
                        break
                    kv = line.split(None, 1)
                    if len(kv) == 1:
                        raise ValueError(f"value missing for option: {line}")
                    cfg.set(kv[0], kv[1])
                modules[(namespace, module)] = cfg

            if kind == "speaker":
                if is_default:
                    if out.default_speaker is not None:
                        raise ValueError("default speaker redefined")
                    out.default_speaker = modules
                else:
                    out.speakers.setdefault(ident, {}).update(modules)
            else:
                if is_default:
                    if out.default_utterance is not None:
                        raise ValueError("default utterance redefined")
                    out.default_utterance = modules
                else:
                    out.utterances.setdefault(ident, {}).update(modules)
        return out

    @classmethod
    def load(cls, path) -> "SpeakerConfig":
        with open(path) as f:
            return cls.parse(f.read())

    # -- lookup -----------------------------------------------------------
    def speaker_params(self, speaker_id: str) -> dict:
        """Module params for a speaker, falling back to the default block."""
        if speaker_id in self.speakers:
            return self.speakers[speaker_id]
        if self.default_speaker is not None:
            return self.default_speaker
        raise KeyError(f"unknown speaker {speaker_id!r} and no default set")

    def utterance_params(self, utterance_id: str) -> dict:
        if utterance_id in self.utterances:
            return self.utterances[utterance_id]
        if self.default_utterance is not None:
            return self.default_utterance
        raise KeyError(f"unknown utterance {utterance_id!r} and no default set")

    # -- writing ----------------------------------------------------------
    def dump(self) -> str:
        import io
        out = io.StringIO()

        def write_block(kind, ident, modules):
            out.write(f"{kind} {ident}\n{{\n")
            for (namespace, module), cfg in modules.items():
                if namespace == "feature":
                    out.write(f"  {module}\n")
                else:
                    out.write(f"  {namespace} {module}\n")
                cfg.write(out, indent=2)
                out.write("\n")
            out.write("}\n\n")

        if self.default_speaker is not None:
            write_block("speaker", "default", self.default_speaker)
        for ident, modules in self.speakers.items():
            write_block("speaker", ident, modules)
        if self.default_utterance is not None:
            write_block("utterance", "default", self.default_utterance)
        for ident, modules in self.utterances.items():
            write_block("utterance", ident, modules)
        return out.getvalue()

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dump())
