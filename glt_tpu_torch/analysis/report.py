"""Findings, severities, suppression parsing and report formatting.

A finding is one (rule, location, message) triple (cf.
``glt_tpu/analysis/report.py``: the same format, suppression syntax and
baseline keys, so a suppression reads the same in both linters).
Suppression is comment driven, pylint style but namespaced to this tool
so the two never collide:

* ``# gltlint: disable=rule-a,rule-b`` on the offending line silences those
  rules for that line only;
* ``# gltlint: disable-next=rule-a`` on the line above silences the line
  below (for lines whose trailing comment space is already spoken for);
* ``# gltlint: disable-file=rule-a`` anywhere in the file silences the rule
  for the whole file;
* the rule list may use rule names (``unbounded-blocking-get``) or
  codes (``GLT007``), and ``all`` matches every rule.

Suppressions should carry a justification comment: the gate treats a
bare suppression the same as a justified one, but a reader cannot.
"""
from __future__ import annotations

import enum
import io
import json
import os
import re
import tokenize
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Set, Tuple


class Severity(enum.IntEnum):
    """Per-rule severity; only ERROR findings fail the gate."""
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error" / "warning" in reports
        return self.name.lower()


@dataclass(frozen=True)
class Finding:
    """One diagnostic emitted by a rule."""
    path: str
    line: int
    col: int
    rule: str          # rule name, e.g. "unbounded-blocking-get"
    code: str          # rule code, e.g. "GLT007"
    severity: Severity
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{str(self.severity).upper()} {self.code} "
                f"[{self.rule}] {self.message}")


_SUPPRESS_RE = re.compile(
    r"#\s*gltlint:\s*(disable|disable-next|disable-file)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")


@dataclass
class Suppressions:
    """Per-file suppression table parsed from comments."""
    by_line: Dict[int, Set[str]] = field(default_factory=dict)
    whole_file: Set[str] = field(default_factory=set)

    @classmethod
    def from_source(cls, source: str) -> "Suppressions":
        sup = cls()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            comments: List[Tuple[int, str]] = [
                (tok.start[0], tok.string) for tok in tokens
                if tok.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return sup
        for line, text in comments:
            for m in _SUPPRESS_RE.finditer(text):
                kind = m.group(1)
                rules = {r.strip().lower()
                         for r in m.group(2).split(",") if r.strip()}
                if kind == "disable-file":
                    sup.whole_file |= rules
                elif kind == "disable-next":
                    sup.by_line.setdefault(line + 1, set()).update(rules)
                else:
                    sup.by_line.setdefault(line, set()).update(rules)
        return sup

    def is_suppressed(self, finding: Finding) -> bool:
        keys = {"all", finding.rule.lower(), finding.code.lower()}
        if keys & self.whole_file:
            return True
        return bool(keys & self.by_line.get(finding.line, set()))


def apply_suppressions(findings: Iterable[Finding],
                       suppressions: Suppressions) -> List[Finding]:
    return [f for f in findings if not suppressions.is_suppressed(f)]


def format_report(findings: List[Finding]) -> str:
    """Human-readable report: findings sorted by location + a summary."""
    lines = [f.format() for f in
             sorted(findings, key=lambda f: (f.path, f.line, f.col))]
    n_err = sum(1 for f in findings if f.severity is Severity.ERROR)
    n_warn = len(findings) - n_err
    if findings:
        lines.append("")
    lines.append(f"gltlint: {n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)


def format_json(findings: List[Finding]) -> str:
    """Machine-readable report: ``{"findings": [...], "summary": ...}``."""
    items = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        d = asdict(f)
        d["severity"] = str(f.severity)
        items.append(d)
    n_err = sum(1 for f in findings if f.severity is Severity.ERROR)
    return json.dumps({
        "findings": items,
        "summary": {"errors": n_err, "warnings": len(findings) - n_err},
    }, indent=2)


def _gh_escape(text: str, prop: bool = False) -> str:
    """GitHub workflow-command escaping (data vs property positions)."""
    out = text.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    if prop:
        out = out.replace(":", "%3A").replace(",", "%2C")
    return out


def format_github(findings: List[Finding]) -> str:
    """GitHub Actions workflow commands: one ``::error``/``::warning``
    annotation per finding (renders inline on the PR diff), plus the
    human summary line for the job log."""
    lines = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        level = "error" if f.severity is Severity.ERROR else "warning"
        title = _gh_escape(f"{f.code} {f.rule}", prop=True)
        lines.append(
            f"::{level} file={_gh_escape(f.path, prop=True)},"
            f"line={f.line},col={f.col},title={title}"
            f"::{_gh_escape(f.message)}")
    n_err = sum(1 for f in findings if f.severity is Severity.ERROR)
    lines.append(f"gltlint: {n_err} error(s), "
                 f"{len(findings) - n_err} warning(s)")
    return "\n".join(lines)


# -- baseline ----------------------------------------------------------------
#
# A baseline lets a new (or newly-strengthened) rule land before the tree
# is fully clean: record today's findings, gate only on findings NOT in
# the record.  Keys deliberately exclude line/column numbers (and mask
# digits inside messages) so unrelated edits that shift code do not
# resurrect baselined findings.

def finding_key(f: Finding) -> str:
    return f"{f.path}|{f.code}|{re.sub(r'[0-9]+', '#', f.message)}"


def load_baseline(path: str) -> Set[str]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"{path}: not a gltlint baseline file")
    return set(data["findings"])


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    keys = sorted({finding_key(f) for f in findings})
    # Atomic publish (GLT011): a gate reads the committed baseline while a
    # developer may be regenerating it — never expose a torn file.
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": keys}, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)


def split_by_baseline(findings: List[Finding], baseline: Set[str]
                      ) -> Tuple[List[Finding], int]:
    """(new findings, number suppressed by the baseline)."""
    fresh = [f for f in findings if finding_key(f) not in baseline]
    return fresh, len(findings) - len(fresh)
