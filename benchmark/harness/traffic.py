"""The one traffic generator: raw grounding samples from a mix's parameters
and the seed.

Every seed gets the same multiset of sizes (phrases an image, tokens a
phrase, narrative lengths, image heights and widths), in an order the seed
draws; the seed also draws the content (token ids, where the phrases sit
in the narrative, pixels, mask rectangles).  So two seeds give the same
work in another order, and the spread between seeds is that of the
measurement, not of the work.

A size is given in a mix as a histogram, ``{"values": [...], "shares":
[...]}``, whose shares are apportioned over the samples by largest
remainder.  ``image_hw`` takes ``[height, width]`` pairs as its values.

A sample is the dict the program's batch builders take (the schema of
``data/synthetic.synthetic_samples``): ``input_ids``, ``mask_ids``,
``spans``, ``masks``, ``mask_infos``, ``image`` (``(h, w, 3)`` uint8),
``img_start`` and ``file_name``.  The prompt is ``img_start`` prompt
tokens, the image block's placeholders and two separators; the caption
follows, with each phrase a span of its own.
"""

from __future__ import annotations

import numpy as np

IMAGE_TOKEN = 5


def apportion(shares, n: int) -> np.ndarray:
    """How many of ``n`` samples each share gets: the floors, then one more
    to the largest remainders (the first of equal ones)."""
    want = np.asarray(shares, np.float64) / float(np.sum(shares)) * n
    counts = np.floor(want).astype(np.int64)
    rest = np.argsort(-(want - counts), kind="stable")[:n - int(counts.sum())]
    counts[rest] += 1
    return counts


def sizes(dist: dict, n: int) -> np.ndarray:
    """The multiset of ``n`` sizes of a histogram, in order (the same for
    every seed)."""
    values = np.asarray(dist["values"], np.int64)
    return np.repeat(values, apportion(dist["shares"], n), axis=0)


def _part_samples(mix: dict, n: int, rng, prompt: dict, tag: str) -> list:
    """``n`` samples of one plain mix."""
    if n == 0:
        return []
    phrases = rng.permutation(sizes(mix["phrases"], n))
    total = int(phrases.sum())
    tokens = rng.permutation(sizes(mix["phrase_tokens"], total))
    narr = mix.get("narrative_tokens")
    narr = (rng.permutation(sizes(narr, n)) if narr else np.zeros(n, int))
    hws = rng.permutation(sizes(mix["image_hw"], n))
    head = (list(rng.integers(10, prompt["vocab"], prompt["img_start"]))
            + [IMAGE_TOKEN] * prompt["n_img"] + [9, 9])
    out, t = [], 0
    for i in range(n):
        k = int(phrases[i])
        tok = [int(x) for x in tokens[t:t + k]]
        t += k
        # at least one token before each phrase; the rest of the narrative
        # scattered over the k gaps and the tail
        length = max(int(narr[i]), sum(tok) + k)
        extra = length - sum(tok) - k
        cuts = np.sort(rng.integers(0, extra + 1, k))
        gaps = 1 + np.diff(np.concatenate([[0], cuts]))
        tail = extra - int(cuts[-1]) if k else extra
        ids, mids, spans = list(head), [-1] * len(head), []
        for m in range(k):
            ids += list(rng.integers(10, prompt["vocab"], int(gaps[m])))
            mids += [-1] * int(gaps[m])
            spans.append((len(ids), len(ids) + tok[m]))
            ids += list(rng.integers(10, prompt["vocab"], tok[m]))
            mids += [m] * tok[m]
        ids += list(rng.integers(10, prompt["vocab"], tail))
        mids += [-1] * tail
        h, w = (int(x) for x in hws[i])
        masks = np.zeros((k, h, w), np.uint8)
        for m in range(k):
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            masks[m, y0:y0 + h // 3 + 1, x0:x0 + w // 3 + 1] = 1
        out.append({
            "input_ids": np.asarray(ids, np.int32),
            "mask_ids": np.asarray(mids, np.int32),
            "spans": spans,
            "masks": masks,
            "mask_infos": [{"plural": False, "isthing": True}] * k,
            "image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "img_start": prompt["img_start"],
            "file_name": f"{tag}_{i}.png",
        })
    return out


def requests(mix: dict, n_requests: int, per_request: int, seed: int,
             prompt: dict) -> list:
    """``n_requests`` lists of ``per_request`` samples.  ``prompt``: the
    configuration's ``img_start`` (before any alignment), ``n_img`` image
    placeholders and ``vocab``.  A mix of mixes fills every request with
    each part's share of its samples."""
    rng = np.random.default_rng(seed)
    parts = mix.get("parts") or [{"share": 1.0, "mix": mix}]
    quotas = [int(round(p["share"] * per_request)) for p in parts]
    quotas[-1] = per_request - sum(quotas[:-1])
    pools = []
    for p, q in zip(parts, quotas):
        samples = _part_samples(p["mix"], q * n_requests, rng, prompt,
                                p["mix"]["name"])
        pools.append(iter(samples))
    out = []
    for _ in range(n_requests):
        req = [s for pool, q in zip(pools, quotas) for s in
               (next(pool) for _ in range(q))]
        out.append([req[i] for i in rng.permutation(len(req))])
    return out


def caption_tokens(request: list) -> int:
    """The phrase tokens of a request: its size for the check's pick of the
    longest."""
    return sum(int((s["mask_ids"] >= 0).sum()) for s in request)
