"""Caption-generation data factory, the offline parts (counterpart of
leclip_tpu/data/gen_captions.py; reference project/gen_cap/:
gen_compositions.py, gen_caption.py, gen_caption_single.py,
gen_caption_challenge.py, filter_caption.py): class-combination sampling
and parsing, the ChatGLM prompt protocol, numbered-sentence splitting, rule
and LLM-judge filtering and labelling, writing the JSON / JSONL / txt
artifacts the data layer reads.

The LLM is any ``chat(prompt) -> str`` callable. The JAX package's
``chatglm_chat`` and ``hf_causal_chat`` adapters need ``transformers`` and
model weights; the port does not depend on that package, and its
adapters raise, naming what they need, without importing anything."""

from __future__ import annotations

import json
import os
import random
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .labeling import CaptionLabeler, contains_chinese
from .vocab import COCO_OBJECT_CATEGORIES

ChatFn = Callable[[str], str]

# Prompt protocol (translations of the reference's templates)
COMPOSITION_PROMPT = (
    "Please randomly select 2 to 10 categories from the following list that "
    "may co-occur in a real scene, and output them as a comma-separated "
    "line: {categories}"
)
CAPTION_PROMPT = (
    "Generate 5 simple sentences describing a realistic scene that contains "
    "all of the following objects: {categories}. Number each sentence."
)
SINGLE_LABEL_PROMPT = (
    "Generate 10 simple sentences describing different realistic scenes. "
    "Each sentence MUST contain a {category}. Number each sentence."
)
CHALLENGE_PROMPT = (
    "Generate 4 simple sentences describing a realistic scene that contains "
    "all of the following objects: {categories}. Number each sentence."
)
JUDGE_PROMPT = (
    "Is the following sentence a realistic, plausible scene description? "
    "Answer True or False only.\nSentence: {caption}"
)
# The reference judge protocol, verbatim (ref filter_caption.py:176-180):
# system prompt + user template concatenated into one chat turn; a caption is
# accepted iff the response contains 'True' and not 'False' (case-sensitive,
# ref :184).
REFERENCE_JUDGE_SYSTEM_PROMPT = (
    "Suppose you are an image describer and I want you to help us to "
    "determine if the provided caption is a good description (need to be "
    "distinguishable, concise and realistic) of a real life scene. Try to "
    "keep sentences with verbs that indicate interaction between objects, "
    "such as hit, wear, play. If so, answer 'True', otherwise answer "
    "'False'. For example, 'A kitchen with a microwave, refrigerator, and "
    "sink.' is 'True'. 'Gorilla waving on the moon' is 'False'."
)
REFERENCE_JUDGE_USER_PROMPT = """
    Provided caption: {caption}.
    """


def judge_accepts(response: str) -> bool:
    """Reference acceptance rule (ref filter_caption.py:184)."""
    return "True" in response and "False" not in response

# The challenge-generation class list (ref gen_caption_challenge.py:10 —
# distinct from the check-dataset hard-class curricula in data/corpora.py).
CHALLENGE_GEN_CLASSES = [
    "parking meter", "backpack", "handbag", "bench", "bottle", "knife",
    "spoon", "chair", "potted plant", "mouse", "remote", "microwave",
    "toaster", "scissors", "hair drier", "toothbrush", "truck",
]

_NUMBERED = re.compile(r"\d+\.\s")


def _needs_transformers(what: str) -> RuntimeError:
    return RuntimeError(
        f"{what} needs the transformers package and local model weights, which "
        "leclip_tpu_torch does not depend on; pass any chat(prompt) -> str callable instead")


def chatglm_chat(model_name: str = "THUDM/chatglm-6b") -> ChatFn:
    """ChatGLM-backed chat: not available in the port (raises)."""
    raise _needs_transformers(f"chatglm_chat({model_name!r})")


def hf_causal_chat(model, tokenizer, max_new_tokens: int = 256, top_p: float = 0.95,
                   temperature: Optional[float] = None) -> ChatFn:
    """HuggingFace causal-LM chat: not available in the port (raises)."""
    raise _needs_transformers("hf_causal_chat")


def sample_composition_pool(
    classnames: Sequence[str] = COCO_OBJECT_CATEGORIES,
    pool_size: int = 10,
    rng: Optional[random.Random] = None,
) -> List[str]:
    """The reference samples 10 of the 80 classes per composition query."""
    rng = rng or random.Random()
    return rng.sample(list(classnames), pool_size)


def parse_composition_response(
    response: str, classnames: Sequence[str] = COCO_OBJECT_CATEGORIES
) -> List[str]:
    """Extract valid class names from a composition response."""
    valid = set(classnames)
    found: List[str] = []
    for line in response.replace(",", "\n").splitlines():
        name = line.strip().strip(".").lower()
        if name in valid and name not in found:
            found.append(name)
    return found


def generate_compositions(
    chat: ChatFn,
    n: int,
    classnames: Sequence[str] = COCO_OBJECT_CATEGORIES,
    seed: int = 0,
    out_path: Optional[str] = None,
) -> Dict[str, Dict[str, List[str]]]:
    """compositions_of_image.json: {id: {category_name: [...]}}."""
    rng = random.Random(seed)
    out: Dict[str, Dict[str, List[str]]] = {}
    for i in range(n):
        pool = sample_composition_pool(classnames, rng=rng)
        response = chat(COMPOSITION_PROMPT.format(categories=", ".join(pool)))
        names = parse_composition_response(response, classnames)
        if names:
            out[str(i)] = {"category_name": names}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return out


def combos_from_compositions(
    compositions: Dict[str, Dict[str, List[str]]]
) -> List[tuple]:
    """Unique sorted category tuples of size >= 2 from a
    compositions_of_image.json dict (ref gen_caption.py:46-56). The reference
    iterates ``list(set(...))`` — set order, nondeterministic across runs; we
    sort for reproducibility (same combo set, stable file contents)."""
    combos = set()
    for value in compositions.values():
        names = value.get("category_name")
        if not names:
            continue
        combo = tuple(sorted(set(names)))
        if len(combo) >= 2:
            combos.add(combo)
    return sorted(combos)


def _join_names(combo: Sequence[str]) -> str:
    """'a, b and c' — the reference's name joining (gen_caption.py:68)."""
    if len(combo) == 1:
        return combo[0]
    return ", ".join(combo[:-1]) + " and " + combo[-1]


def generate_caption_texts(
    chat: ChatFn,
    combos: Sequence[Sequence[str]],
    loops: int = 4,
    st: int = 0,
    ed: Optional[int] = None,
    save_root: Optional[str] = None,
) -> List[str]:
    """The gen_caption.py raw-dump stage: per combo in [st:ed], ``loops``
    caption-generation chats; raw responses are appended to
    ``captions_{st}_{ed}.txt`` under a ``[{idx}] {combo}`` header — the exact
    artifact format filter_caption.py consumes (ref gen_caption.py:63-82).
    Returns the raw responses (header lines excluded)."""
    ed = len(combos) if ed is None else ed
    out_path = None
    if save_root:
        os.makedirs(save_root, exist_ok=True)
        out_path = os.path.join(save_root, f"captions_{st}_{ed}.txt")
    responses: List[str] = []
    for idx, combo in enumerate(combos[st:ed]):
        names = _join_names(list(combo))
        block = [f"[{idx}] {tuple(combo)}\n"]
        for _ in range(loops):
            response = chat(CAPTION_PROMPT.format(categories=names))
            responses.append(response)
            block.append(response + "\n")
        if out_path:
            with open(out_path, "a", encoding="utf-8") as f:
                f.writelines(block)
    return responses


def read_raw_caption_texts(path: str) -> List[str]:
    """Recover caption lines from a raw ``captions_{st}_{ed}.txt`` dump (or a
    directory of them) for ``filter_captions``: keeps only lines containing a
    numbered-sentence marker, like the reference's reader (ref
    filter_caption.py simple_filter_cap txt branch) — combo headers and LLM
    preamble prose never reach the filter."""
    paths = (
        [os.path.join(path, f) for f in sorted(os.listdir(path))
         if f.endswith(".txt")]
        if os.path.isdir(path) else [path]
    )
    lines: List[str] = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                m = _NUMBERED.search(line)
                if m:
                    # drop prose before the first marker (the reference keeps
                    # only post-marker content, so "Here are 5 sentences:"
                    # preambles never become caption candidates)
                    lines.append(line[m.start():].strip("\n"))
    return lines


def split_numbered_sentences(text: str) -> List[str]:
    """Split a numbered ChatGLM response into sentences (regex `\\d+\\.\\s`,
    ref filter_caption.py:93-163). Returns cleaned sentences."""
    parts = _NUMBERED.split(text)
    return [p.strip() for p in parts if p.strip()]


def reference_sentence_split(sentence: str, colon_rule: bool = False) -> List[str]:
    """The reference's EXACT chained-split of one line on `\\d+\\.\\s` markers
    (ref filter_caption.py simple_filter_cap, :104-116 txt / :124-145 json):
    zero markers → no sentences; one marker → everything after it;
    several markers → successive `split(m)[0]` / `split(m)[-1]` segments plus
    the final remainder. ``colon_rule`` is the json branch's time-string
    heuristic (:129-134): a multi-marker sentence containing ':' is treated
    as ONE sentence ("… at 11:59. A person …" — the "59. " is a time, not a
    numbering). Trailing spaces and marker-duplication quirks are preserved."""
    matches = _NUMBERED.findall(sentence)
    if not matches:
        return []
    if len(matches) == 1 or (colon_rule and ":" in sentence):
        return [sentence.split(matches[0])[-1]]
    out: List[str] = []
    rest = sentence.split(matches[0])[-1]
    for m in matches[1:]:
        out.append(rest.split(m)[0])
        rest = rest.split(m)[-1]
    out.append(rest.split(matches[-1])[-1])
    return out


def simple_filter_captions(caption_dir: str) -> List[str]:
    """Stage-1 of the caption filter: walk a directory of raw generation
    dumps (`.txt` = one response line per row; `.json` = {key: [sentences]}),
    chain-split every numbered line, and drop Chinese sentences — the exact
    behaviour of the reference's ``simple_filter_cap``
    (ref filter_caption.py:94-163). Files are visited in sorted order (the
    reference uses ``os.listdir``, whose order is filesystem-dependent)."""
    out: List[str] = []
    for fname in sorted(os.listdir(caption_dir)):
        path = os.path.join(caption_dir, fname)
        sentences: List[str] = []
        if fname.endswith(".txt"):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    sentences.extend(reference_sentence_split(line.strip("\n")))
        elif fname.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                cap_dict = json.load(f)
            for value in cap_dict.values():
                for sentence in value:
                    sentences.extend(
                        reference_sentence_split(sentence, colon_rule=True))
        out.extend(s for s in sentences if not contains_chinese(s))
    return out


def rule_filter_sentence(sent: str, min_len: int = 5, max_len: int = 150) -> bool:
    return (
        not contains_chinese(sent)
        and min_len < len(sent) < max_len
    )


def filter_captions(
    raw_responses: Iterable[str],
    labeler: Optional[CaptionLabeler] = None,
    judge: Optional[ChatFn] = None,
    out_path: Optional[str] = None,
    presplit: bool = False,
) -> List[dict]:
    """The reference's ``filter_cap`` pipeline (ref filter_caption.py:165-200):
    stage-1 chained numbered-sentence split + Chinese drop (per response
    line); stage-2 LLM realism judge with the verbatim reference prompt and
    its 'True'-and-not-'False' acceptance rule; then the 5<len<150 length
    gate and labeling into the ``ChatGLM_multi_labels_filtered.json`` format
    [{id, caption, labels}] — ``labels`` being the MATCHED SYNONYM NAMES (the
    reference's get_class there returns names, not a binary vector,
    filter_caption.py:33-76), and label-less captions are KEPT with an empty
    list, exactly as the reference does. Downstream corpus loaders re-derive
    binary labels from the caption text, so only {id, caption} is load-bearing."""
    labeler = labeler or CaptionLabeler()
    selected: List[str] = []
    for response in raw_responses:
        # ``presplit``: the caller already ran stage-1 (simple_filter_captions
        # — which also handles the reference's .json dumps); each item is one
        # sentence, not a marker-bearing response line.
        sents = [response] if presplit else reference_sentence_split(response)
        for sent in sents:
            if contains_chinese(sent):
                continue
            if judge is not None:
                prompt = REFERENCE_JUDGE_SYSTEM_PROMPT + \
                    REFERENCE_JUDGE_USER_PROMPT.format(caption=sent)
                if not judge_accepts(judge(prompt)):
                    continue
            selected.append(sent)
    kept: List[dict] = []
    for cap in selected:
        if 5 < len(cap) < 150:
            kept.append({"id": len(kept), "caption": cap,
                         "labels": labeler.matched_names(cap)})
    if out_path:
        with open(out_path, "w") as f:
            json.dump(kept, f, indent=4)
    return kept


def generate_single_label_corpus(
    chat: ChatFn,
    classnames: Sequence[str] = COCO_OBJECT_CATEGORIES,
    loops: int = 1,
    out_dir: Optional[str] = None,
    start_index: int = 1,
) -> List[Dict[str, List[str]]]:
    """ChatGLM_single_label_{t}.json files: {class_idx: [numbered lines]}."""
    files = []
    for t in range(loops):
        corpus: Dict[str, List[str]] = {}
        for idx, cname in enumerate(classnames):
            response = chat(SINGLE_LABEL_PROMPT.format(category=cname))
            lines = [
                f"{i + 1}. {s}" for i, s in enumerate(split_numbered_sentences(response))
                if rule_filter_sentence(s)
            ]
            corpus[str(idx)] = lines
        files.append(corpus)
        if out_dir:
            path = os.path.join(out_dir, f"ChatGLM_single_label_{start_index + t}.json")
            with open(path, "w") as f:
                json.dump(corpus, f)
    return files


def generate_challenge_corpus(
    chat: ChatFn,
    compositions: Iterable[Sequence[str]],
    challenge_classes: Sequence[str],
    out_path: Optional[str] = None,
) -> List[dict]:
    """captions_score_challenge.jsonl lines {labels, captions}: each combo is
    intersected with the challenge-class list (ref gen_caption_challenge.py)."""
    challenge = set(challenge_classes)
    lines: List[dict] = []
    for combo in compositions:
        subset = sorted(set(combo) & challenge)
        if not subset:
            continue
        response = chat(CHALLENGE_PROMPT.format(categories=", ".join(subset)))
        captions = [
            f"{i + 1}. {s}" for i, s in enumerate(split_numbered_sentences(response))
            if rule_filter_sentence(s)
        ]
        if captions:
            lines.append({"labels": subset, "captions": captions})
    if out_path:
        with open(out_path, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return lines
