"""CLI flag parsing — the ArgParser analog (`include/ArgParser.h`).

Same behavioral contract as the reference parser:
- case-insensitive token[+value] matching (`ArgParser.h:63-96`),
- typed handlers (int/float/bool-flip/lambda),
- `?` prints a help listing of all registered flags and exits
  (`ArgParser.h:105-127` pops a MessageBox; here it prints).

Flag set registered by the app (`Particles.cpp:251-267`): numparticles,
nogui, noext, size, intensity, novsync, fullscreen, numCopy, numDraw,
numSim — all preserved, plus extensions beyond the reference.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Sequence


class ArgParser:
    def __init__(self, description: str = ""):
        self.description = description
        self._specs: List[tuple] = []  # (token, help, handler, takes_value)

    # -- registration ---------------------------------------------------------
    def add_flag(self, token: str, help_text: str, handler: Callable[[], None]):
        """Value-less flag: presence flips/invokes."""
        self._specs.append((token.lower(), help_text, handler, False))

    def add_int(self, token: str, help_text: str, handler: Callable[[int], None]):
        self._specs.append((token.lower(), help_text, lambda s: handler(int(s, 0)), True))

    def add_float(self, token: str, help_text: str, handler: Callable[[float], None]):
        self._specs.append((token.lower(), help_text, lambda s: handler(float(s)), True))

    def add_str(self, token: str, help_text: str, handler: Callable[[str], None]):
        self._specs.append((token.lower(), help_text, handler, True))

    # -- parsing ---------------------------------------------------------------
    def help_text(self) -> str:
        lines = [self.description, ""]
        for token, help_text, _, takes_value in self._specs:
            arg = f"-{token} <v>" if takes_value else f"-{token}"
            lines.append(f"  {arg:<24} {help_text}")
        return "\n".join(lines)

    def parse(self, argv: Optional[Sequence[str]] = None, exit_on_help: bool = True):
        argv = list(sys.argv[1:] if argv is None else argv)
        i = 0
        unmatched = []
        while i < len(argv):
            tok = argv[i].lstrip("-/").lower()
            if tok == "?":
                print(self.help_text())
                if exit_on_help:
                    raise SystemExit(0)
                return unmatched
            matched = False
            for token, _, handler, takes_value in self._specs:
                if tok == token:
                    if takes_value:
                        if i + 1 >= len(argv):
                            raise ValueError(f"flag -{token} expects a value")
                        handler(argv[i + 1])
                        i += 1
                    else:
                        handler()
                    matched = True
                    break
            if not matched:
                unmatched.append(argv[i])
            i += 1
        return unmatched
