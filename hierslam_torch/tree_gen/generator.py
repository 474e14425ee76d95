"""Offline LLM-driven semantic-tree generation (port of
``hierslam_tpu/tree_gen/generator.py``; pure Python, the JAX package's
copy is reached only through its JAX-importing package).

Bottom-up agglomerative clustering of leaf class names: while more than
``stop_groups`` groups remain, ask an LLM to partition the current label
set into named groups, validate that every label was covered (re-prompting
for any missing ones), then recurse on the group names.  The result is a
per-leaf path of group names per level, serialized to the
``info_semantic_tree.json`` structure the Replica loader reads.

The LLM client is any callable ``prompt -> str``.  ``make_openai_client``
builds one on the OpenAI chat API (imported only when called); nothing at
SLAM time needs it.
"""
from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence


def make_openai_client(model: str = "gpt-4o-mini", api_key: Optional[str] = None) -> Callable[[str], str]:
    """LLM callable backed by the OpenAI chat API (LLM_tree/chatgpt.py:13-22)."""
    from openai import OpenAI  # optional dependency

    client = OpenAI(api_key=api_key)

    def ask(prompt: str) -> str:
        resp = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}]
        )
        return resp.choices[0].message.content

    return ask


GROUPING_PROMPT = """You are organizing object classes found in indoor scenes
into a semantic hierarchy. Partition ALL of the following labels into at
most {max_groups} named groups of semantically similar things. Every label
must appear in exactly one group. Answer ONLY with JSON of the form
{{"group name": ["label", ...], ...}}.

Labels: {labels}
"""

MISSING_PROMPT = """These labels were not assigned to any group: {missing}.
Assign each of them to one of the existing groups: {groups}.
Answer ONLY with JSON {{"group name": ["label", ...]}}.
"""


def _parse_json_block(text: str) -> Dict[str, List[str]]:
    m = re.search(r"\{.*\}", text, re.S)
    if not m:
        raise ValueError(f"no JSON object in LLM reply: {text[:200]}")
    return json.loads(m.group(0))


def generate_tree_one_layer(
    labels: Sequence[str],
    ask: Callable[[str], str],
    max_groups: int,
    max_retries: int = 3,
) -> Dict[str, List[str]]:
    """One agglomeration step with coverage validation + re-prompting
    (LLM_tree/chatgpt.py:137-156)."""
    grouping = _parse_json_block(
        ask(GROUPING_PROMPT.format(max_groups=max_groups, labels=list(labels)))
    )
    # dedupe: keep first assignment only
    seen = set()
    for g, ls in grouping.items():
        grouping[g] = [l for l in ls if l in labels and not (l in seen or seen.add(l))]
    for _ in range(max_retries):
        missing = [l for l in labels if l not in seen]
        if not missing:
            break
        fix = _parse_json_block(
            ask(MISSING_PROMPT.format(missing=missing, groups=list(grouping)))
        )
        for g, ls in fix.items():
            grouping.setdefault(g, [])
            for l in ls:
                if l in labels and l not in seen:
                    grouping[g].append(l)
                    seen.add(l)
    still = [l for l in labels if l not in seen]
    if still:
        grouping.setdefault("other", []).extend(still)
    return {g: ls for g, ls in grouping.items() if ls}


def generate_tree(
    leaf_labels: Sequence[str],
    ask: Callable[[str], str],
    stop_groups: int = 4,
    shrink: float = 0.5,
    max_levels: int = 8,
) -> List[Dict[str, List[str]]]:
    """Bottom-up clustering until <= stop_groups remain
    (LLM_tree/gen_tree.py:13-25, 96-109).  Returns the per-level groupings
    from finest to coarsest."""
    layers: List[Dict[str, List[str]]] = []
    current = list(leaf_labels)
    while len(current) > stop_groups and len(layers) < max_levels:
        max_groups = max(stop_groups, int(len(current) * shrink))
        grouping = generate_tree_one_layer(current, ask, max_groups)
        if len(grouping) >= len(current):
            break
        layers.append(grouping)
        current = list(grouping.keys())
    return layers


def tree_to_paths(
    leaf_labels: Sequence[str], layers: List[Dict[str, List[str]]]
) -> Dict[str, List[str]]:
    """leaf -> [coarsest ... finest] group-name path."""
    paths = {}
    for leaf in leaf_labels:
        node = leaf
        path = []
        for layer in layers:
            for g, members in layer.items():
                if node in members:
                    node = g
                    break
            path.append(node)
        paths[leaf] = list(reversed(path))
    return paths


def assign_level_ids(paths: Dict[str, List[str]]) -> Dict[str, Dict]:
    """Serialize to the info_semantic_tree.json structure consumed by the
    Replica loader (datasets/gradslam_datasets/replica.py:630-674):
    ``"<leaf_idx>_<leaf>" -> [ {level_id: level_name}, ... ]`` with dense
    per-level ids."""
    n_levels = max(len(p) for p in paths.values()) if paths else 0
    id_maps: List[Dict[tuple, int]] = [dict() for _ in range(n_levels)]
    out = {}
    for idx, (leaf, path) in enumerate(paths.items()):
        full = path + [leaf] * (n_levels - len(path))
        entry = []
        for lv in range(n_levels):
            key = tuple(full[: lv + 1])
            if key not in id_maps[lv]:
                id_maps[lv][key] = len(id_maps[lv])
            entry.append({str(id_maps[lv][key]): full[lv]})
        out[f"{idx}_{leaf}"] = entry
    return out


def save_tree_json(tree: Dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(tree, f, indent=1)
    return path
