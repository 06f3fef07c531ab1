"""docqa-lint CLI for the port: run the checkers over a tree.

Usage:
    python -m docqa_tpu_torch.analysis              # the gate: the port's
                                                    # tree (exit 1 on new
                                                    # or stale)
    python -m docqa_tpu_torch.analysis docqa_tpu_torch --rules phi-taint
    python -m docqa_tpu_torch.analysis --update-baseline   # accept current
    python -m docqa_tpu_torch.analysis --no-baseline       # raw findings
    python -m docqa_tpu_torch.analysis --format json
    python -m docqa_tpu_torch.analysis --rules host-sync,dispatch-streams
    python -m docqa_tpu_torch.analysis --wire-audit --device cpu
    python -m docqa_tpu_torch.analysis --api-md      # the API document

The gate fails (exit 1) on any finding not in the baseline AND on any
stale baseline entry (accepted finding that no longer fires) — the
checked-in ledger (``docqa_tpu_torch/analysis/lint_baseline.json``) must
match the tree exactly.  Per-line suppressions (``# docqa-lint:
disable=<rule>``) are applied before baselining.  ``--update-baseline``
keeps the justification of every entry that still fires and every entry
outside the run's rules or paths; a new entry gets ``TODO: justify``,
which the tests refuse until a real reason replaces it.

``--wire-audit`` boots the fake-mode runtime on ``--device`` (the card by
default), drives every route over HTTP on 127.0.0.1, validates each
response against ``api_contract.json`` and round-trips a broker journal;
it exits 1 on any violation and writes the report to ``--report`` when
given.  ``--api-md`` prints the endpoint reference rendered from the
contract.
"""

from __future__ import annotations

import argparse
import json
import sys

from docqa_tpu_torch.analysis.core import (
    Baseline,
    all_checkers,
    analyze_paths,
    default_baseline_path,
    package_dir,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m docqa_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="package directories (or single files) to analyze "
        "(default: the docqa_tpu_torch package)",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help=f"comma-separated subset of: {', '.join(sorted(all_checkers()))}",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help="baseline JSON path (default: "
        "docqa_tpu_torch/analysis/lint_baseline.json)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline: report every finding and exit 1 on any",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to accept every current finding "
        "(justifications in existing entries are preserved)",
    )
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "--wire-audit",
        action="store_true",
        help="run the live wire audit instead of the static rules",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="the wire audit's device (default: cuda)",
    )
    parser.add_argument("--report", default=None, help="wire audit report path")
    parser.add_argument(
        "--api-md",
        action="store_true",
        help="print the API document rendered from api_contract.json",
    )
    args = parser.parse_args(argv)

    if args.api_md or args.wire_audit:
        from docqa_tpu_torch.analysis import wire_audit

        if args.api_md:
            contract = wire_audit.load_contract(wire_audit.default_ledger_path())
            sys.stdout.write(wire_audit.render_api_md(contract))
            return 0
        report = wire_audit.run_wire_audit(
            device=args.device, report_path=args.report
        )
        cov = report["coverage"]
        print(
            f"wire audit: {cov['driven']}/{cov['registered']} routes driven, "
            f"{cov['declared']} declared, {report['violations_total']} "
            f"violation(s), journal {'ok' if report['journal']['ok'] else 'FAILED'}"
        )
        for key, row in report["endpoints"].items():
            for v in row["violations"]:
                print(f"{key} [{row['status']}]: {v}")
        return 0 if report["ok"] else 1

    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    paths = args.paths or [package_dir()]
    # one parse pass yields both the findings and the run's scope: a
    # --rules or sub-path invocation must neither report out-of-scope
    # baseline entries as stale nor (on update) destroy them
    findings, analyzed = analyze_paths(paths, rules=rules)
    active_rules = set(rules) if rules else set(all_checkers())

    baseline_path = args.baseline or default_baseline_path()
    if args.update_baseline:
        updated = Baseline.load(baseline_path).updated(
            findings, active_rules, analyzed
        )
        updated.save(baseline_path)
        print(
            f"baseline updated: {len(updated.entries)} entrie(s) -> "
            f"{baseline_path}"
        )
        return 0

    if args.no_baseline:
        new, matched, stale = findings, [], []
    else:
        baseline = Baseline.load(baseline_path)
        new, matched, stale = baseline.split(findings)
        stale = [
            e
            for e in stale
            if e.get("rule") in active_rules and e.get("path") in analyzed
        ]

    if args.format == "json":
        print(
            json.dumps(
                {
                    "new": [f.__dict__ for f in new],
                    "baselined": [f.__dict__ for f in matched],
                    "stale_baseline_entries": stale,
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f.format())
        for e in stale:
            print(
                f"STALE baseline entry (no longer fires): [{e.get('rule')}] "
                f"{e.get('path')} {e.get('symbol')}: {e.get('message')}"
            )
        print(
            f"docqa-lint: {len(new)} new finding(s), {len(matched)} "
            f"baselined, {len(stale)} stale baseline entrie(s)"
        )
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
