"""gltlint command line for the port: ``python -m glt_tpu_torch.analysis
[paths]`` (cf. ``glt_tpu/analysis/cli.py``, with the same flags).

The CLI parses the whole file set into one :class:`~.symbols.Project`
(symbol table -> call graph -> effect summaries) and runs every rule per
module with the project attached, so the interprocedural rules
(GLT008/GLT009, GLT014 one call deep, GLT024-027) see across files.

Exit codes: 0 = clean (or warnings only), 1 = at least one gating ERROR
finding, 2 = usage/parse problems (a file that cannot be parsed is
reported as an error finding, not a crash — the gate must not go green
on a syntax error).

Output modes (``--format``): ``text`` (default), ``json``, ``github``
(workflow-command annotations that render inline on PRs).  A committed
``--baseline`` file gates only on findings not already recorded
(``--write-baseline`` records the current set); ``--profile`` prints
per-pass timings to stderr.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .report import (
    Finding,
    Severity,
    Suppressions,
    apply_suppressions,
    format_github,
    format_json,
    format_report,
    load_baseline,
    split_by_baseline,
    write_baseline,
)
from .rules import RULES, Rule, all_rules
from .kernelmodel import CUDA_SUFFIXES, cuda_findings  # noqa: I100  (after rules: it registers them)
from .symbols import Project
from .visitor import ModuleInfo, module_name_for_path

_FORMATTERS = {"text": format_report, "json": format_json,
               "github": format_github}


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def build_project(paths: Iterable[str]
                  ) -> Tuple[Project, List[Finding]]:
    """Parse every file into one project; unparseable/unreadable files
    become findings (never crashes the gate)."""
    findings: List[Finding] = []
    modules: List[ModuleInfo] = []
    seen_names: Dict[str, int] = {}
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as exc:
            findings.append(Finding(
                path=path, line=1, col=1, rule="io-error", code="GLT000",
                severity=Severity.ERROR, message=str(exc)))
            continue
        name = module_name_for_path(path)
        # de-collide duplicate stems from unrelated directories
        if name in seen_names:
            seen_names[name] += 1
            name = f"{name}#{seen_names[name]}"
        else:
            seen_names[name] = 0
        try:
            modules.append(ModuleInfo(path, source, module_name=name))
        except SyntaxError as exc:
            findings.append(Finding(
                path=path, line=exc.lineno or 1, col=(exc.offset or 1),
                rule="parse-error", code="GLT000",
                severity=Severity.ERROR,
                message=f"cannot parse: {exc.msg}"))
    return Project(modules), findings


def analyze_project(project: Project,
                    rules: Optional[Sequence[Rule]] = None,
                    suppress: bool = True,
                    rule_timings: Optional[Dict[str, float]] = None,
                    only_paths: Optional[Iterable[str]] = None
                    ) -> List[Finding]:
    """Run the given rules (default: all) over every project module.

    When ``rule_timings`` is given, each rule's cumulative wall time
    across all modules is accumulated into it (keyed by rule name) —
    the ``--profile`` per-pass table reads this.

    ``only_paths`` restricts the *rule passes* to those module paths
    (the incremental ``--changed``/``--since`` mode): the whole file
    set is still parsed into the project, so cross-file resolution and
    effect summaries stay sound, but per-module rule work — the
    dominant cost as the tree grows — runs only on the changed slice.
    """
    rules = list(rules) if rules is not None else all_rules()
    selected = (None if only_paths is None
                else {os.path.abspath(p) for p in only_paths})
    findings: List[Finding] = []
    for path in sorted(project.by_path):
        if selected is not None \
                and os.path.abspath(path) not in selected:
            continue
        module = project.by_path[path]
        module_findings: List[Finding] = []
        for rule in rules:
            if rule_timings is None:
                module_findings.extend(rule.check(module, project))
                continue
            t0 = time.perf_counter()
            module_findings.extend(rule.check(module, project))
            rule_timings[rule.name] = (rule_timings.get(rule.name, 0.0)
                                       + time.perf_counter() - t0)
        if suppress and module_findings:   # tokenizing clean files is
            module_findings = apply_suppressions(   # pure overhead
                module_findings, Suppressions.from_source(module.source))
        findings.extend(module_findings)
    return findings


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Sequence[Rule]] = None,
                   suppress: bool = True) -> List[Finding]:
    """Run the given rules (default: all) over one module's source.

    The module is wrapped in a single-module project, so the
    interprocedural rules work within the file (cross-file effects need
    :func:`analyze_paths` / :func:`analyze_project`).
    """
    rules = list(rules) if rules is not None else all_rules()
    if path.endswith(CUDA_SUFFIXES):
        return cuda_findings(source, path, rules)
    try:
        module = ModuleInfo(path, source)
    except SyntaxError as exc:
        return [Finding(path=path, line=exc.lineno or 1,
                        col=(exc.offset or 1), rule="parse-error",
                        code="GLT000", severity=Severity.ERROR,
                        message=f"cannot parse: {exc.msg}")]
    project = Project([module])
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(module, project))
    if suppress:
        findings = apply_suppressions(findings,
                                      Suppressions.from_source(source))
    return findings


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    project, findings = build_project(paths)
    return findings + analyze_project(project, rules)


def _git_changed_files(since: str) -> Optional[List[str]]:
    """Repo paths changed since ``since`` (tracked diffs + untracked
    files), or None when git is unavailable — the caller falls back to
    a full run rather than silently linting nothing."""
    import subprocess

    def run(*cmd: str) -> Optional[List[str]]:
        try:
            proc = subprocess.run(
                list(cmd), capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        return [ln for ln in proc.stdout.splitlines() if ln]

    diffed = run("git", "diff", "--name-only", since, "--")
    if diffed is None:
        return None
    untracked = run("git", "ls-files", "--others",
                    "--exclude-standard") or []
    return sorted(set(diffed) | set(untracked))


def _select_rules(select: Optional[str], ignore: Optional[str]
                  ) -> List[Rule]:
    by_key = {}
    for cls in RULES.values():
        rule = cls()
        by_key[rule.name] = rule
        by_key[rule.code.lower()] = rule
    def lookup(spec: str) -> List[Rule]:
        out = []
        for key in spec.split(","):
            key = key.strip().lower()
            if not key:
                continue
            if key not in by_key:
                raise SystemExit(f"gltlint: unknown rule {key!r} "
                                 f"(see --list-rules)")
            out.append(by_key[key])
        return out
    rules = lookup(select) if select else all_rules()
    if ignore:
        dropped = {r.name for r in lookup(ignore)}
        rules = [r for r in rules if r.name not in dropped]
    return rules


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m glt_tpu_torch.analysis",
        description="gltlint: static analysis of glt_tpu_torch's threads, "
                    "locks, wire protocol and storage reads")
    parser.add_argument("paths", nargs="*", default=["glt_tpu_torch"],
                        help="files or directories to analyze "
                             "(default: glt_tpu_torch)")
    parser.add_argument("--select", metavar="RULES",
                        help="comma-separated rule names/codes to run")
    parser.add_argument("--rule", metavar="RULE",
                        help="run exactly one rule (name or code) and "
                             "skip the call-graph/effect build — the "
                             "fast inner loop while fixing one finding "
                             "class")
    parser.add_argument("--ignore", metavar="RULES",
                        help="comma-separated rule names/codes to skip")
    parser.add_argument("--strict", action="store_true",
                        help="treat warnings as errors for the exit code")
    parser.add_argument("--format",
                        choices=sorted(_FORMATTERS) + ["optable"],
                        default="text", dest="fmt",
                        help="report format (default: text; 'github' "
                             "emits PR-inline workflow annotations; "
                             "'optable' dumps the extracted wire-op "
                             "table as a markdown matrix instead of "
                             "findings)")
    parser.add_argument("--changed", action="store_true",
                        help="incremental mode: run rule passes only "
                             "on files changed vs HEAD (plus untracked "
                             "files); the whole tree is still parsed "
                             "so cross-file resolution stays sound")
    parser.add_argument("--since", metavar="REV",
                        help="like --changed, diffed against REV "
                             "instead of HEAD")
    parser.add_argument("--baseline", metavar="FILE",
                        help="gate only on findings not recorded in this "
                             "baseline file")
    parser.add_argument("--write-baseline", metavar="FILE",
                        help="record the current findings as the "
                             "baseline and exit 0")
    parser.add_argument("--profile", action="store_true",
                        help="print per-pass timings to stderr")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name:32s} {rule.severity!s:8s} "
                  f"{rule.description}")
        return 0

    if args.rule and args.select:
        parser.error("--rule and --select are mutually exclusive")
    if args.rule:
        if "," in args.rule:
            parser.error("--rule takes exactly one rule "
                         "(use --select for a list)")
        rules = _select_rules(args.rule, args.ignore)
    else:
        rules = _select_rules(args.select, args.ignore)
    timings: List[Tuple[str, float]] = []
    t0 = time.perf_counter()
    project, findings = build_project(args.paths)
    timings.append(("parse+symbols", time.perf_counter() - t0))

    if args.fmt == "optable":
        from .protocol import extract_op_table, format_op_table
        print(format_op_table(extract_op_table(project)))
        for f in findings:               # parse failures must not hide
            print(f.format(), file=sys.stderr)
        return 2 if findings else 0

    only_paths: Optional[List[str]] = None
    if args.changed or args.since:
        only_paths = _git_changed_files(args.since or "HEAD")
        if only_paths is None:
            print("gltlint: --changed/--since needs git; running the "
                  "full file set", file=sys.stderr)
        elif args.profile:
            print(f"gltlint --profile: incremental slice: "
                  f"{len(only_paths)} changed file(s)", file=sys.stderr)

    if not args.rule:
        # Single-rule mode skips the forced build: a rule that needs
        # effects still triggers it lazily, but intraprocedural passes
        # stay fast for the fix-one-finding inner loop.
        t0 = time.perf_counter()
        project.effects        # force callgraph + effect summaries
        timings.append(("callgraph+effects", time.perf_counter() - t0))
    t0 = time.perf_counter()
    rule_timings: Dict[str, float] = {}
    findings = findings + analyze_project(
        project, rules,
        rule_timings=rule_timings if args.profile else None,
        only_paths=only_paths)
    timings.append(("rules", time.perf_counter() - t0))

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"gltlint: wrote {len(findings)} finding(s) to baseline "
              f"{args.write_baseline}")
        return 0

    baselined = 0
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as exc:
            print(f"gltlint: cannot read baseline: {exc}",
                  file=sys.stderr)
            return 2
        findings, baselined = split_by_baseline(findings, baseline)

    print(_FORMATTERS[args.fmt](findings))
    if baselined and args.fmt == "text":
        print(f"gltlint: {baselined} baselined finding(s) hidden "
              f"({args.baseline})")
    if args.profile:
        total = sum(dt for _, dt in timings)
        for name, dt in timings:
            print(f"gltlint --profile: {name:18s} {dt * 1e3:8.1f} ms",
                  file=sys.stderr)
        for name, dt in sorted(rule_timings.items(),
                               key=lambda kv: -kv[1]):
            print(f"gltlint --profile:   pass {name:26s} "
                  f"{dt * 1e3:8.1f} ms", file=sys.stderr)
        print(f"gltlint --profile: {'total':18s} {total * 1e3:8.1f} ms",
              file=sys.stderr)
    gate = (findings if args.strict else
            [f for f in findings if f.severity is Severity.ERROR])
    return 1 if gate else 0


if __name__ == "__main__":
    sys.exit(main())
