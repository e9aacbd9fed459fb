"""Minimal Prometheus text exposition: render and parse (a copy of
``kubeshare_tpu/utils/expfmt.py``, pure stdlib).

The wire format shared by the node side: the collector's
``tpu_capacity``, the requirement samples the config daemon reads
(``tpu_requirement``) and the launcher's ``/metrics``. Components scrape
each other directly, so a Prometheus server in the middle is an
optimisation, not a dependency. Only the subset of the format emitted
here is supported: HELP/TYPE comments, gauge samples with string
labels, float values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional

_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape(value: str) -> str:
    return "".join(_ESCAPES.get(c, c) for c in value)


def _unescape(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


@dataclass
class Sample:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0

    def render(self) -> str:
        if self.labels:
            inner = ",".join(
                f'{k}="{_escape(str(v))}"' for k, v in sorted(self.labels.items())
            )
            return f"{self.name}{{{inner}}} {self.value}"
        return f"{self.name} {self.value}"


_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def render(
    samples: Iterable[Sample],
    help_text: Optional[Mapping[str, str]] = None,
) -> str:
    """Render samples grouped by metric family. ``x_bucket``/``x_sum``/
    ``x_count`` series roll up under one ``# TYPE x histogram`` — but
    only when an ``x_bucket{le=...}`` sibling actually exists, so a
    plain gauge that merely ends in ``_count`` keeps its own name,
    family comment, and help text."""
    samples = list(samples)
    hist_families = {
        s.name[: -len("_bucket")]
        for s in samples
        if s.name.endswith("_bucket") and "le" in s.labels
    }

    def family(name: str) -> str:
        for suffix in _HIST_SUFFIXES:
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and base in hist_families:
                return base
        return name

    by_family: Dict[str, List[Sample]] = {}
    for s in samples:
        by_family.setdefault(family(s.name), []).append(s)
    lines: List[str] = []
    for fam in sorted(by_family):
        if help_text and fam in help_text:
            lines.append(f"# HELP {fam} {help_text[fam]}")
        kind = "histogram" if fam in hist_families else "gauge"
        lines.append(f"# TYPE {fam} {kind}")
        lines.extend(s.render() for s in by_family[fam])
    return "\n".join(lines) + ("\n" if lines else "")


def parse(text: str) -> List[Sample]:
    """Parse text exposition into samples (gauges only).

    Malformed lines — e.g. a scrape truncated mid-body — are skipped,
    not fatal: this is the ingestion path for data from remote
    components, and one bad line must not poison a whole scrape.
    """
    samples: List[Sample] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            samples.append(_parse_line(line))
        except (ValueError, IndexError):
            continue
    return samples


def _parse_line(line: str) -> Sample:
    labels: Dict[str, str] = {}
    if "{" in line:
        name, rest = line.split("{", 1)
        body, _, tail = rest.rpartition("}")
        if not _:
            raise ValueError(f"unterminated label set: {line!r}")
        value = float(tail.strip().split()[0])
        i = 0
        while i < len(body):
            eq = body.index("=", i)
            key = body[i:eq].strip().lstrip(",").strip()
            if body[eq + 1] != '"':
                raise ValueError(f"unquoted label value in {line!r}")
            j = eq + 2
            buf = []
            while body[j] != '"':
                if body[j] == "\\":
                    buf.append(body[j : j + 2])
                    j += 2
                else:
                    buf.append(body[j])
                    j += 1
            labels[key] = _unescape("".join(buf))
            i = j + 1
    else:
        parts = line.split()
        name, value = parts[0], float(parts[1])
    return Sample(name=name.strip(), labels=labels, value=value)


def select(
    samples: Iterable[Sample], name: str, **label_filters: str
) -> List[Sample]:
    """Samples of family ``name`` whose labels match all ``label_filters``."""
    out = []
    for s in samples:
        if s.name != name:
            continue
        if all(s.labels.get(k) == v for k, v in label_filters.items()):
            out.append(s)
    return out
