"""The port's copy of ``llama_kotlin_tpu/tools/tokenize.py``.

Tokenize utility (parity: examples/tokenize/tokenize.cpp): print the
token ids and pieces a GGUF model's tokenizer produces for a prompt."""

from __future__ import annotations

import argparse
import sys


def tokenize(model_path: str, text: str, *, add_special: bool = True,
             parse_special: bool = False, ids_only: bool = False) -> list[int]:
    from llama_kotlin_tpu_torch.gguf.reader import GGUFFile
    from llama_kotlin_tpu_torch.tokenizer import build_tokenizer

    f = GGUFFile(model_path)
    tok = build_tokenizer(f.metadata)
    f.close()
    ids = tok.encode(text, add_special=add_special, parse_special=parse_special)
    for tid in ids:
        if ids_only:
            print(tid)
        else:
            piece = tok.id_to_piece(tid)
            print(f"{tid:>8} -> '{piece.decode('utf-8', 'backslashreplace')}'")
    return list(ids)


def main(argv=None):
    ap = argparse.ArgumentParser(description="tokenize a prompt")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--prompt", "-p", default=None)
    ap.add_argument("--file", "-f", help="read prompt from file")
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--ids", action="store_true", help="print ids only")
    ap.add_argument("--no-bos", action="store_true")
    ap.add_argument("--parse-special", action="store_true")
    args = ap.parse_args(argv)
    if args.stdin:
        text = sys.stdin.read()
    elif args.file:
        text = open(args.file, encoding="utf-8").read()
    elif args.prompt is not None:
        text = args.prompt
    else:
        ap.error("need --prompt, --file or --stdin")
    tokenize(args.model, text, add_special=not args.no_bos,
             parse_special=args.parse_special, ids_only=args.ids)


if __name__ == "__main__":
    main()
