"""The port's copy of ``llama_kotlin_tpu/tools/gbnf_validator.py``.

GBNF validator (parity: examples/gbnf-validator/gbnf-validator.cpp):
parse a grammar file and check whether an input string is accepted,
reporting the failure position otherwise."""

from __future__ import annotations

import argparse
import sys


def validate(grammar_text: str, input_text: str) -> tuple[bool, int]:
    """Returns (accepted, error_position). error_position is the codepoint
    offset of the first unacceptable character (== len on premature EOF)."""
    from llama_kotlin_tpu_torch.sampling.grammar import Grammar, parse_gbnf

    rules, root = parse_gbnf(grammar_text)
    g = Grammar(rules, root)
    for i, ch in enumerate(input_text):
        if not g.accept_cp(ord(ch)):
            return False, i
    if not g.can_end:
        return False, len(input_text)
    return True, -1


def main(argv=None):
    ap = argparse.ArgumentParser(description="validate input against a GBNF grammar")
    ap.add_argument("grammar_file")
    ap.add_argument("input_file")
    args = ap.parse_args(argv)
    grammar_text = open(args.grammar_file, encoding="utf-8").read()
    input_text = open(args.input_file, encoding="utf-8").read()
    ok, pos = validate(grammar_text, input_text)
    if ok:
        print("Input string is valid according to the grammar.")
        return 0
    lo, hi = max(0, pos - 40), min(len(input_text), pos + 40)
    print("Input string is invalid according to the grammar.")
    print(f"Error at character {pos}:")
    print(input_text[lo:hi])
    print(" " * (pos - lo) + "^")
    return 1


if __name__ == "__main__":
    sys.exit(main())
