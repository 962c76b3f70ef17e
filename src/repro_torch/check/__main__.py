"""CLI dispatch: ``python -m repro_torch.check {lint,dynamic} ...``."""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.check {lint,dynamic} [options]\n"
              "  lint     static AST rules (R001-R006) vs check_baseline"
              ".json\n"
              "  dynamic  sync-debug / capture / finite-superstep gates "
              "(D001-D003)")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "lint":
        from repro_torch.check.lint import main as lint_main
        return lint_main(rest)
    if cmd == "dynamic":
        from repro_torch.check.dynamic import main as dynamic_main
        return dynamic_main(rest)
    print(f"repro_torch.check: unknown command {cmd!r} (expected "
          f"lint|dynamic)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
