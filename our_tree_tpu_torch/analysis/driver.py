"""Port of ``our_tree_tpu.analysis.driver``: the otlint CLI over the port.

``python -m our_tree_tpu_torch.analysis`` with no arguments lints
``our_tree_tpu_torch/`` only and audits the plain versions' graphs. The
gate is::

    python -m our_tree_tpu_torch.analysis \\
        --baseline our_tree_tpu_torch/analysis/baseline.json --fail-on-new

which exits 1 on any finding the committed baseline does not match by
fingerprint; known ones report as suppressed, and stale baseline entries
(fixed violations) are named so the file cannot rot.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import astrules, baseline as baseline_mod
from .findings import SEVERITIES


#: The committed baseline, beside this module.
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def _repo_root() -> str:
    """The repo root: parent of the our_tree_tpu_torch package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _default_paths(root: str) -> list[str]:
    return [os.path.join(root, "our_tree_tpu_torch")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.analysis",
        description="otlint over the port: repo-invariant AST linter, "
                    "graph auditor and ot-san")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the "
                         "our_tree_tpu_torch package)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="suppress findings fingerprint-matched by this "
                         "baseline file "
                         "(our_tree_tpu_torch/analysis/baseline.json)")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 when any non-baselined finding exists "
                         "(the CI gate)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the current findings as a baseline, "
                         "preserving reasons from --baseline; new entries "
                         "get a TODO reason the loader rejects until "
                         "justified")
    ap.add_argument("--fix", action="store_true",
                    help="apply the rules' MECHANICAL rewrites in "
                         "place before linting (currently: the "
                         "wallclock rule's time.time()/time_ns() -> "
                         "monotonic twin), then report the post-fix "
                         "state — a fixed file re-lints clean for the "
                         "fixing rule")
    ap.add_argument("--no-ast", action="store_true",
                    help="skip layer 1 (the AST linter)")
    ap.add_argument("--no-graph", action="store_true",
                    help="skip layer 2 (the graph auditor) — the AST layer "
                         "then runs without torch in sight")
    ap.add_argument("--san", action="store_true",
                    help="run the ot-san concurrency auditor (whole-"
                         "program call graph + effect inference: "
                         "loop-stall, lock-await, lock-order, "
                         "thread-ownership)")
    ap.add_argument("--format", default="text", choices=("text", "json"))
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in astrules.RULES:
            print(f"{rule.id} ({rule.severity}): {rule.doc}")
        from . import sanrules

        for rule in sanrules.RULES:
            print(f"{rule.id} ({rule.severity}): [san v{rule.version}] "
                  f"{rule.doc}")
        from .graph_audit import RULE_DOCS

        for rule, (severity, doc) in RULE_DOCS.items():
            print(f"{rule} ({severity}): [graph] {doc}")
        return 0

    root = _repo_root()
    findings = []
    if args.fix:
        # Baselined violations are EXEMPT from fixing (a reasoned
        # baseline entry marks a deliberate site — mechanically
        # rewriting it would be semantically wrong, e.g. devlock's
        # epoch-vs-mtime staleness compare), so the baseline loads
        # before the rewrites run — and a bare `--fix` with no
        # --baseline flag still protects the COMMITTED baseline's
        # sites (the one place the reasons live; an unprotected
        # default would rewrite exactly the sites the reasons exist
        # for).
        fix_baseline_path = args.baseline or BASELINE
        fix_base: dict = {}
        if os.path.exists(fix_baseline_path):
            try:
                fix_base = baseline_mod.load(fix_baseline_path)
            except baseline_mod.BaselineError as e:
                print(f"BASELINE ERROR: {e}", file=sys.stderr)
                return 2
        paths = ([os.path.abspath(p) for p in args.paths]
                 if args.paths else _default_paths(root))
        fixed = astrules.fix_paths(paths, root, baseline=fix_base)
        for rel, n in sorted(fixed.items()):
            print(f"# otlint --fix: {rel}: {n} rewrite(s)",
                  file=sys.stderr)
        print(f"# otlint --fix: {sum(fixed.values())} rewrite(s) in "
              f"{len(fixed)} file(s)", file=sys.stderr)
    if not args.no_ast:
        paths = ([os.path.abspath(p) for p in args.paths]
                 if args.paths else _default_paths(root))
        findings += astrules.lint_paths(paths, root)
    if args.san:
        from . import sanrules

        paths = ([os.path.abspath(p) for p in args.paths]
                 if args.paths else _default_paths(root))
        findings += sanrules.analyze_paths(paths, root)
    if not args.no_graph:
        from . import graph_audit

        findings += graph_audit.audit()

    # Staleness is judged only over the layers that actually RAN: a
    # `--no-graph` lint must not report the graph entries as fixed,
    # and a run without --san must not condemn the san entries.
    active_layers = set()
    if not args.no_ast:
        active_layers.add("ast")
    if args.san:
        active_layers.add("san")
    if not args.no_graph:
        active_layers.add("graph")

    stale: list[str] = []
    base: dict[str, dict] = {}
    if args.baseline and os.path.exists(args.baseline):
        try:
            base = baseline_mod.load(args.baseline)
        except baseline_mod.BaselineError as e:
            print(f"BASELINE ERROR: {e}", file=sys.stderr)
            return 2
        stale = [fp for fp in baseline_mod.apply(findings, base)
                 if fp.split(":", 1)[0] in active_layers]

    if args.write_baseline:
        n = baseline_mod.write(args.write_baseline, findings, base)
        print(f"# wrote {n} baseline entr{'y' if n == 1 else 'ies'} to "
              f"{args.write_baseline}", file=sys.stderr)

    new = [f for f in findings if not f.baselined]
    known = [f for f in findings if f.baselined]
    order = {s: i for i, s in enumerate(SEVERITIES)}
    key = lambda f: (order.get(f.severity, 9), f.path, f.line, f.rule)

    if args.format == "json":
        print(json.dumps({
            "new": [f.to_json() for f in sorted(new, key=key)],
            "baselined": [f.to_json() for f in sorted(known, key=key)],
            "stale_baseline": stale,
        }, indent=2))
    else:
        for f in sorted(new, key=key) + sorted(known, key=key):
            print(f.render())
        for fp in stale:
            entry = base.get(fp, {})
            print(f"# stale baseline entry {fp} "
                  f"({entry.get('location', '?')}, {entry.get('rule', '?')})"
                  " — the violation is gone; delete the entry",
                  file=sys.stderr)
        print(f"# otlint: {len(new)} new finding(s), {len(known)} "
              f"baselined, {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}", file=sys.stderr)

    if new and args.fail_on_new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
