"""Caption-generation CLI (counterpart of leclip_tpu/cli/gen_captions.py): the
reference's offline caption stage as one command with subcommands (ref
project/gen_cap/: gen_compositions.py, gen_caption.py,
gen_caption_single.py, gen_caption_challenge.py, filter_caption.py).

``filter`` (without ``--judge``) runs on files alone. The subcommands that
ask an LLM take the ``chat`` callable given to :func:`main`; from the
command line, ``--chatglm`` / ``--hf`` name the JAX package's backends,
which need the transformers package and local weights, and raise in this package
(data/gen_captions.py).

Usage:
    python -m leclip_tpu_torch.cli.gen_captions filter --captions gen_caption/ \
        --out ChatGLM_multi_labels_filtered.json
    main(["captions", "--compositions", "comp.json", "--save-root", "gen_caption/"],
         chat=my_chat)
"""

from __future__ import annotations

import argparse
import json
import os


def _make_chat(args, chat=None):
    from ..data import gen_captions as G

    if chat is not None:
        return chat
    if args.hf:
        return G.hf_causal_chat(args.hf, None, max_new_tokens=args.max_new_tokens,
                                temperature=args.temperature)
    return G.chatglm_chat(args.chatglm)


def main(argv=None, chat=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--chatglm", default="THUDM/chatglm-6b",
                    help="ChatGLM model name/dir (default backend)")
    ap.add_argument("--hf", default="",
                    help="local HuggingFace causal-LM dir (overrides --chatglm)")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=None)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compositions", help="sample class co-occurrence combos")
    p.add_argument("--n", type=int, default=6000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="compositions_of_image.json")

    p = sub.add_parser("captions", help="multi-label caption raw dumps")
    p.add_argument("--compositions", required=True)
    p.add_argument("--save-root", default="gen_caption")
    p.add_argument("--st", type=int, default=0)
    p.add_argument("--ed", type=int, default=None)
    p.add_argument("--loops", type=int, default=4)

    p = sub.add_parser("single", help="single-label corpus files")
    p.add_argument("--loops", type=int, default=1)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--start-index", type=int, default=1)
    p.add_argument("--classes", default="",
                   help="comma-separated classnames (default: the 80 COCO "
                        "classes)")

    p = sub.add_parser("challenge", help="hard-class challenge JSONL corpus")
    p.add_argument("--compositions", required=True)
    p.add_argument("--out", default="captions_score_challenge.jsonl")
    p.add_argument("--classes", default="",
                   help="comma-separated challenge classes (default: the "
                        "reference's 17-class list)")

    p = sub.add_parser("filter", help="rule + judge filtering → labeled json")
    p.add_argument("--captions", required=True,
                   help="captions_{st}_{ed}.txt file or directory of them")
    p.add_argument("--out", default="ChatGLM_multi_labels_filtered.json")
    p.add_argument("--judge", action="store_true",
                   help="stage-2 LLM realism judge (needs a backend)")

    args = ap.parse_args(argv)

    from ..data import gen_captions as G

    if args.cmd == "compositions":
        out = G.generate_compositions(
            _make_chat(args, chat), args.n, seed=args.seed, out_path=args.out
        )
        print(f"wrote {args.out}: {len(out)} compositions")
    elif args.cmd == "captions":
        with open(args.compositions) as f:
            combos = G.combos_from_compositions(json.load(f))
        responses = G.generate_caption_texts(
            _make_chat(args, chat), combos, loops=args.loops, st=args.st,
            ed=args.ed, save_root=args.save_root,
        )
        print(f"wrote {args.save_root}: {len(responses)} raw responses "
              f"({len(combos)} combos total)")
    elif args.cmd == "single":
        kwargs = {}
        if args.classes:
            kwargs["classnames"] = [
                c.strip() for c in args.classes.split(",") if c.strip()
            ]
        G.generate_single_label_corpus(
            _make_chat(args, chat), loops=args.loops, out_dir=args.out_dir,
            start_index=args.start_index, **kwargs,
        )
        print(f"wrote {args.loops} single-label files under {args.out_dir}")
    elif args.cmd == "challenge":
        with open(args.compositions) as f:
            combos = G.combos_from_compositions(json.load(f))
        classes = (
            [c.strip() for c in args.classes.split(",") if c.strip()]
            or G.CHALLENGE_GEN_CLASSES
        )
        lines = G.generate_challenge_corpus(
            _make_chat(args, chat), combos, classes, out_path=args.out
        )
        print(f"wrote {args.out}: {len(lines)} challenge lines")
    elif args.cmd == "filter":
        judge = _make_chat(args, chat) if args.judge else None
        if os.path.isdir(args.captions):
            # stage-1 via simple_filter_captions: covers the reference's
            # .json caption dumps (colon time-string rule included) as well
            # as .txt response files (ref filter_caption.py:94-163)
            raw = G.simple_filter_captions(args.captions)
            kept = G.filter_captions(raw, judge=judge, out_path=args.out,
                                     presplit=True)
        else:
            raw = G.read_raw_caption_texts(args.captions)
            kept = G.filter_captions(raw, judge=judge, out_path=args.out)
        print(f"wrote {args.out}: {len(kept)} labeled captions "
              f"(from {len(raw)} raw lines)")


if __name__ == "__main__":
    main()
