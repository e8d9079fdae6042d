"""The port's copy of the JAX package's ``observability/promtext.py`` (it
imports nothing of that package); names and behaviour are as there, on
the port's ``metrics`` formatters.

Prometheus text-exposition (format 0.0.4) PARSER — the inverse of
``metrics.render()``.

Three consumers read exposition documents today and each grew its own
string handling: the loadgen scraper (benchmark/loadgen.py) snapshots a
live LB's /metrics into a time series, ``tools/bench_compare.py``-style
gates diff counter values between runs, and tests assert on scraped
families. Ad-hoc ``"name 5" in text`` checks break the moment a label
is added or a float renders differently, so the parsing lives HERE
once, exactly dual to the renderer: ``parse(render(reg))`` recovers
every sample bit-for-bit and ``render_families(parse(text)) == text``
for any renderer-produced document (the round-trip the golden tests
pin).

Shapes:

    families = promtext.parse(text)   # name -> Family
    fam = families["stpu_lb_requests_total"]
    fam.kind                          # "counter" | "gauge" |
                                      # "histogram" | "untyped"
    fam.samples                       # [Sample(name, labels, value)]
    promtext.value(families, "stpu_engine_up")
    promtext.counter_total(families, "stpu_lb_requests_total",
                           code="200")
    snap = promtext.histogram(families, "stpu_engine_ttft_seconds")
    snap.quantile(0.99)               # interpolated, like PromQL's
                                      # histogram_quantile

Histogram samples (``_bucket``/``_sum``/``_count``) attach to their
declared family; ``HistogramSnapshot`` carries the cumulative bucket
counts and delegates quantile interpolation to
``metrics.quantile_from_cumulative`` so a quantile computed from a
scrape and one computed live from a ``Histogram`` child can never
disagree. ``delta()`` subtracts two snapshots of the same histogram —
the run-scoped distribution between two scrapes, which is what an SLO
report wants (the live histogram is cumulative since process start).

Stdlib-only, like everything else in observability/.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from skypilot_tpu_torch.observability import metrics as _metrics


@dataclasses.dataclass
class Sample:
    name: str
    labels: Tuple[Tuple[str, str], ...]   # sorted (name, value) pairs
    value: float

    def label(self, key: str, default: str = "") -> str:
        for k, v in self.labels:
            if k == key:
                return v
        return default


@dataclasses.dataclass
class Family:
    name: str
    kind: str = "untyped"
    help: str = ""
    samples: List[Sample] = dataclasses.field(default_factory=list)


class ParseError(ValueError):
    """Malformed exposition text."""


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text in ("NaN", "nan"):
        return math.nan
    return float(text)


def _unescape_label(value: str) -> str:
    """Inverse of metrics._escape_label: \\\\ -> \\, \\n -> newline,
    \\" -> "  (processed left to right, so an escaped backslash never
    re-triggers)."""
    out: List[str] = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_labels(body: str, line: str
                  ) -> Tuple[Tuple[str, str], ...]:
    """Parse the inside of a ``{...}`` label block. A hand-rolled
    scanner because label VALUES may contain commas, quotes, and
    escaped backslashes — splitting on "," corrupts exactly the inputs
    the escaping exists for."""
    labels: List[Tuple[str, str]] = []
    i = 0
    while i < len(body):
        eq = body.find("=", i)
        if eq < 0:
            raise ParseError(f"bad label block in line {line!r}")
        name = body[i:eq].strip()
        if not name or body[eq + 1:eq + 2] != '"':
            raise ParseError(f"bad label block in line {line!r}")
        j = eq + 2
        raw: List[str] = []
        while j < len(body):
            ch = body[j]
            if ch == "\\" and j + 1 < len(body):
                raw.append(body[j:j + 2])
                j += 2
                continue
            if ch == '"':
                break
            raw.append(ch)
            j += 1
        else:
            raise ParseError(f"unterminated label value in {line!r}")
        labels.append((name, _unescape_label("".join(raw))))
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
    return tuple(labels)


_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def parse(text: str) -> Dict[str, Family]:
    """Parse one exposition document into ``{name: Family}``. Sample
    order within a family and family order in the document are
    preserved (render_families round-trips). Unknown/extra text raises
    ParseError — a scraper must not silently misread a document."""
    families: Dict[str, Family] = {}

    def family(name: str) -> Family:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = Family(name)
        return fam

    def owner(sample_name: str) -> Family:
        # _bucket/_sum/_count of a DECLARED histogram family attach to
        # it; otherwise the sample owns its literal name.
        for suffix in _HIST_SUFFIXES:
            if sample_name.endswith(suffix):
                base = sample_name[:-len(suffix)]
                fam = families.get(base)
                if fam is not None and fam.kind == "histogram":
                    return fam
        return family(sample_name)

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            family(name).help = help_text
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ParseError(f"bad TYPE line {line!r}")
            family(parts[2]).kind = parts[3]
            continue
        if line.startswith("#"):
            continue                     # other comments are legal
        # Sample line: name[{labels}] value
        brace = line.find("{")
        labels: Tuple[Tuple[str, str], ...] = ()
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ParseError(f"bad sample line {line!r}")
            name = line[:brace]
            labels = _parse_labels(line[brace + 1:close], line)
            value_text = line[close + 1:].strip()
        else:
            try:
                name, value_text = line.split(None, 1)
            except ValueError as e:
                raise ParseError(f"bad sample line {line!r}") from e
        try:
            value = _parse_value(value_text.split()[0])
        except (ValueError, IndexError) as e:
            raise ParseError(f"bad sample value in {line!r}") from e
        owner(name).samples.append(Sample(name, labels, value))
    return families


def render_families(families: Dict[str, Family]) -> str:
    """Render parsed families back to exposition text — the golden
    round-trip partner of parse(); matches metrics.render()'s layout
    (HELP then TYPE then samples, one trailing newline)."""
    out: List[str] = []
    for fam in families.values():
        out.append(f"# HELP {fam.name} {fam.help}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            out.append(
                f"{s.name}"
                f"{_metrics._format_labels([k for k, _ in s.labels], [v for _, v in s.labels])}"
                f" {_metrics._format_value(s.value)}")
    return "\n".join(out) + "\n" if out else ""


def _match(sample: Sample, want: Dict[str, str]) -> bool:
    have = dict(sample.labels)
    return all(have.get(k) == str(v) for k, v in want.items())


def value(families: Dict[str, Family], name: str,
          default: float = 0.0, **labels: str) -> float:
    """The first sample of ``name`` matching the given labels (subset
    match), or ``default``. For counters/gauges."""
    fam = families.get(name)
    if fam is None:
        return default
    for s in fam.samples:
        if s.name == name and _match(s, labels):
            return s.value
    return default


def counter_total(families: Dict[str, Family], name: str,
                  **labels: str) -> float:
    """Sum of every ``name`` sample matching the label subset — e.g.
    all codes of a requests counter, or one code across methods."""
    fam = families.get(name)
    if fam is None:
        return 0.0
    return sum(s.value for s in fam.samples
               if s.name == name and _match(s, labels))


@dataclasses.dataclass
class HistogramSnapshot:
    """One histogram series (or label-aggregated family) at scrape
    time: ``bounds`` are the finite upper bounds, ``cumulative`` the
    cumulative counts INCLUDING the trailing +Inf bucket."""
    bounds: List[float]
    cumulative: List[float]
    sum: float
    count: float

    def quantile(self, q: float) -> float:
        return _metrics.quantile_from_cumulative(
            self.bounds, self.cumulative, q)

    def delta(self, earlier: "HistogramSnapshot"
              ) -> "HistogramSnapshot":
        """This snapshot minus an ``earlier`` one of the SAME series —
        the distribution of observations made between the two scrapes
        (live histograms are cumulative since process start, so an SLO
        report over a run window needs the difference, not the
        total)."""
        if earlier.bounds != self.bounds:
            raise ValueError("histogram bucket bounds changed between "
                             "snapshots; delta undefined")
        return HistogramSnapshot(
            bounds=list(self.bounds),
            cumulative=[max(a - b, 0.0) for a, b in
                        zip(self.cumulative, earlier.cumulative)],
            sum=max(self.sum - earlier.sum, 0.0),
            count=max(self.count - earlier.count, 0.0))


def histogram(families: Dict[str, Family], name: str,
              **labels: str) -> Optional[HistogramSnapshot]:
    """Reassemble ``name``'s bucket/sum/count samples into one
    HistogramSnapshot. Label-subset matching; series sharing the same
    bucket layout are SUMMED bucket-wise (e.g. every ``code`` of the
    LB latency histogram when no code is named). None when the family
    has no matching samples."""
    fam = families.get(name)
    if fam is None or fam.kind != "histogram":
        return None
    # Group buckets by their non-le label set.
    series: Dict[Tuple[Tuple[str, str], ...], Dict[float, float]] = {}
    sums: Dict[Tuple[Tuple[str, str], ...], float] = {}
    counts: Dict[Tuple[Tuple[str, str], ...], float] = {}
    for s in fam.samples:
        ident = tuple(kv for kv in s.labels if kv[0] != "le")
        if not _match(Sample(s.name, ident, 0.0), labels):
            continue
        if s.name == name + "_bucket":
            le = s.label("le")
            series.setdefault(ident, {})[_parse_value(le)] = s.value
        elif s.name == name + "_sum":
            sums[ident] = s.value
        elif s.name == name + "_count":
            counts[ident] = s.value
    if not series:
        return None
    layouts = {tuple(sorted(b)) for b in series.values()}
    if len(layouts) > 1:
        raise ValueError(
            f"{name}: matched series disagree on bucket bounds; "
            "name more labels")
    all_bounds = sorted(next(iter(layouts)))
    merged = [sum(b[bound] for b in series.values())
              for bound in all_bounds]
    finite = [b for b in all_bounds if not math.isinf(b)]
    return HistogramSnapshot(
        bounds=finite,
        cumulative=merged,
        sum=sum(sums.get(i, 0.0) for i in series),
        count=sum(counts.get(i, 0.0) for i in series))
