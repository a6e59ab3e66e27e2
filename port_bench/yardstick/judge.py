"""The comparison that decides ``correct``.

Every answer the window received (each photo of each call answered 200:
its top-k class indices and scores) is held against the plain reference's
softmax of the same photo, computed after the window from the same JPEG
bytes and the same weight arrays. One number is compared, ``answer_gap``,
in natural-log units of probability, so that a relative error reads alike
on a likely and an unlikely class: over every answer and rank j, the wider
of two gaps,

- ``score_gap``: between a served score and the reference's probability
  of the class it names, |ln s − ln p[iⱼ]| (a wrong score, or a wrong
  class with its own score);
- ``rank_gap``: by which the class served at rank j lies below the
  reference's j-th most likely class, ln p₍ⱼ₎ − ln p[iⱼ] (0 when the
  served order is the reference's; a class left out, or a wrong class
  served with its right probability).

Besides it a run is held to its configuration's guarantee, every call
answered 200 (``failed_calls``), and to whole answers: one result of k
predictions for every photo sent (``malformed``).
"""

from __future__ import annotations

import json

import numpy as np


def served_answers(calls, call_photos: list[list[int]], k: int):
    """(photo ids, indices [n, k], scores [n, k], malformed calls) of every
    call answered 200."""
    photos, idx, scores, malformed = [], [], [], 0
    for call in calls:
        if not call.ok:
            continue
        try:
            answer = json.loads(call.answer)
            # several photos answer {"results": [...]}, one {"predictions": ...}
            results = answer["results"] if "results" in answer else [answer]
            sent = call_photos[call.body]
            if len(results) != len(sent):
                raise ValueError("one result a photo")
            rows = [[(p["index"], p["score"]) for p in r["predictions"]] for r in results]
            if any(len(r) != k for r in rows):
                raise ValueError(f"{k} predictions a photo")
        except (ValueError, KeyError, TypeError):
            malformed += 1
            continue
        for photo, row in zip(sent, rows):
            photos.append(photo)
            idx.append([i for i, _ in row])
            scores.append([s for _, s in row])
    return (np.asarray(photos, np.int64), np.asarray(idx, np.int64).reshape(-1, k),
            np.asarray(scores, np.float64).reshape(-1, k), malformed)


def topk(probs: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The k most likely classes of each row and their probabilities."""
    idx = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(probs, idx, 1)


def gaps(photos: np.ndarray, idx: np.ndarray, scores: np.ndarray, ref: np.ndarray) -> dict:
    """``answer_gap`` and its two parts, ``score_gap`` and ``rank_gap``, of
    answers (photo ids, served indices and scores) against the reference's
    probabilities ``ref`` [photos, classes]."""
    if not len(photos):
        nan = float("nan")
        return {"answer_gap": nan, "score_gap": nan, "rank_gap": nan}
    k = idx.shape[1]
    with np.errstate(divide="ignore"):
        p = np.log(ref[photos])  # [n, classes]
        served = np.take_along_axis(p, idx, 1)
        best = -np.sort(-p, axis=1)[:, :k]
        score_gap = np.abs(np.log(scores) - served)
    score_gap, rank_gap = float(np.max(score_gap)), float(np.max(best - served))
    return {"answer_gap": max(score_gap, rank_gap), "score_gap": score_gap,
            "rank_gap": rank_gap}


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number compared."""
    return {name: {"value": numbers[name], "limit": limits[name]} for name in limits}


def passed(table: dict) -> bool:
    """Every value at or under its limit (a NaN never is)."""
    return all(v["value"] <= v["limit"] for v in table.values())
