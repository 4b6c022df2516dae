"""Noun-phrase extraction for grounded conversation
(flmm_tpu/generation/noun_chunks.py, carried over unchanged: plain Python).

The reference uses spaCy noun chunks (scripts/demo/grounded_conversation
.py:11,38-61).  Without spaCy the default is a light heuristic chunker
(determiner/adjective runs ending in nouns); spaCy is used automatically
when importable, so both packages give the same spans either way.  Returns
character spans so they can be mapped to token spans exactly like the
reference (:105-113).
"""

from __future__ import annotations

import re

_STOP = {
    "i", "you", "he", "she", "it", "we", "they", "this", "that", "these",
    "those", "there", "here", "what", "which", "who", "whom", "image",
    "picture", "photo", "one", "thing", "something", "anything", "left",
    "right", "top", "bottom", "side", "view", "foreground", "background",
}

_VERBS_ETC = {
    "is", "are", "was", "were", "be", "been", "being", "am", "has", "have",
    "had", "do", "does", "did", "can", "could", "will", "would", "shall",
    "should", "may", "might", "must", "and", "or", "but", "of", "in", "on",
    "at", "to", "for", "with", "by", "from", "as", "into", "onto", "over",
    "under", "about", "between", "while", "when", "where", "because",
    "appears", "looks", "seems", "shows", "depicts", "contains", "wearing",
    "holding", "standing", "sitting", "walking", "running", "very", "not",
}

_DET_ADJ = {"a", "an", "the", "its", "his", "her", "their", "some", "two",
            "three", "several", "many", "small", "large", "big", "little",
            "young", "old", "red", "blue", "green", "yellow", "white",
            "black", "brown", "gray", "grey", "orange", "purple", "pink",
            "wooden", "metal", "plastic", "tall", "short", "long", "round"}


def noun_chunks(text: str) -> list[tuple[int, int, str]]:
    """Extract noun-phrase character spans ``(start, end, text)``."""
    try:
        import spacy  # optional

        try:
            nlp = spacy.load("en_core_web_sm")
            doc = nlp(text)
            out = []
            for c in doc.noun_chunks:
                t = c.text.strip()
                if t.lower() not in _STOP:
                    out.append((c.start_char, c.end_char, t))
            return out
        except OSError:
            pass
    except ImportError:
        pass
    return _heuristic_chunks(text)


def _heuristic_chunks(text: str) -> list[tuple[int, int, str]]:
    tokens = [(m.start(), m.end(), m.group(0)) for m in
              re.finditer(r"[A-Za-z][A-Za-z'-]*", text)]
    chunks = []
    run: list[tuple[int, int, str]] = []

    def flush():
        nonlocal run
        while run and run[0][2].lower() in _DET_ADJ | _STOP:
            head = run[0][2].lower()
            if head in _DET_ADJ and len(run) > 1:
                break
            run = run[1:]
        if run:
            head = run[-1][2].lower()
            if head not in _STOP and head not in _DET_ADJ:
                s, e = run[0][0], run[-1][1]
                chunks.append((s, e, text[s:e]))
        run = []

    for tok in tokens:
        w = tok[2].lower()
        if w in _VERBS_ETC:
            flush()
        else:
            run.append(tok)
    flush()
    # dedupe by text, keep first occurrence
    seen = set()
    out = []
    for s, e, t in chunks:
        key = t.lower()
        if key not in seen:
            seen.add(key)
            out.append((s, e, t))
    return out


def char_span_to_token_span(
    tokenizer, output_ids, char_span: tuple[int, int]
) -> tuple[int, int] | None:
    """Map a character span of the decoded text to a token span, the way
    the reference does (grounded_conversation.py:105-113): via cumulative
    decoded lengths of the id prefix."""
    s_char, e_char = char_span
    start = end = None
    text = ""
    for i, _ in enumerate(output_ids):
        new_text = tokenizer.decode(output_ids[:i + 1])
        if start is None and len(new_text) > s_char:
            start = i
        if len(new_text) >= e_char:
            end = i + 1
            break
        text = new_text
    if start is None or end is None or end <= start:
        return None
    return (start, end)
