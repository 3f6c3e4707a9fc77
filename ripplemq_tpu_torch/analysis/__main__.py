"""ripplelint CLI for the PyTorch port.

    python -m ripplemq_tpu_torch.analysis                # findings
    python -m ripplemq_tpu_torch.analysis --json         # machine verdict
    python -m ripplemq_tpu_torch.analysis --rule markers # one rule
    python -m ripplemq_tpu_torch.analysis --list         # known rules

Exit status 0 iff the tree is clean: zero unwaived findings AND zero
stale waivers (a suppression that stopped matching is coverage rot and
fails just like a finding). The JSON verdict carries per-checker
finding counts and runtimes for all 11 rules. The lint parses ASTs
only: it imports none of the checked modules and needs no device.

Waiving a finding: add a `(rule, key, reason)` entry to
`ripplemq_tpu_torch/analysis/ledger.py` — the key is printed with every
finding; the reason is mandatory.
"""

from __future__ import annotations

import argparse
import json
import sys

from ripplemq_tpu_torch.analysis import CHECKERS, run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ripplemq_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the machine-readable verdict")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list known rules and exit")
    args = ap.parse_args(argv)

    if args.list:
        for rule in CHECKERS:
            print(rule)
        return 0

    report = run_lint(rules=args.rule)
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["ok"] else 1

    for rule, c in report["checkers"].items():
        waived = f", {len(c['waived'])} waived" if c["waived"] else ""
        print(f"{rule}: {c['count']} finding(s){waived} "
              f"[{c['runtime_s']:.2f}s]")
        for f in c["findings"]:
            print(f"  {f['path']}:{f['line']}: {f['message']}")
            print(f"      key: {f['key']}")
    for w in report["stale_waivers"]:
        print(f"STALE WAIVER {w['rule']}::{w['key']} — no finding matches "
              f"(remove it from ripplemq_tpu_torch/analysis/ledger.py)")
    status = "clean" if report["ok"] else "DIRTY"
    print(f"ripplelint (port): {status} — {report['unwaived_total']} "
          f"unwaived finding(s), {len(report['stale_waivers'])} stale "
          f"waiver(s), {report['runtime_s']:.2f}s")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
