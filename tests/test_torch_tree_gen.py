"""The port's LLM tree generator against the JAX package's, with one stub
client on both sides (nothing calls out): identical groupings per level,
leaf paths, level ids and JSON, which the port's Replica tree reader
loads.  Pure Python on both sides: compared for equality."""
import json

import pytest

from hierslam_torch.datasets.tree import find_max_level, read_tree_annotation
from hierslam_torch.tree_gen import generator as tgen
from hierslam_tpu.tree_gen import generator as jgen

LABELS = ["chair", "sofa", "table", "bed", "wall", "floor", "ceiling", "lamp", "cushion",
          "blinds"]


def stub_client(forget=()):
    """A fake LLM: groups by fixed rules, leaves out ``forget`` in its first
    answer (so the generator re-prompts for them) and records each prompt."""
    prompts = []

    def ask(prompt):
        prompts.append(prompt)
        if "not assigned" in prompt:
            return "Sure: " + json.dumps({"soft things": list(forget)})
        if "chair" in prompt:
            groups = {"furniture": ["chair", "sofa", "table", "bed", "chair"],
                      "structure": ["wall", "floor", "ceiling", "blinds"],
                      "lighting": ["lamp"], "soft things": ["cushion", "not a label"]}
            return "```json\n" + json.dumps(
                {g: [x for x in ls if x not in forget] for g, ls in groups.items()}) + "\n```"
        return json.dumps({"indoor": ["furniture", "lighting", "soft things"],
                           "shell": ["structure"]})

    return ask, prompts


@pytest.mark.parametrize("forget", [(), ("cushion", "lamp")])
def test_tree_generator_matches_jax(tmp_path, forget):
    ask_t, prompts_t = stub_client(forget)
    ask_j, prompts_j = stub_client(forget)
    layers = tgen.generate_tree(LABELS, ask_t, stop_groups=2)
    assert layers == jgen.generate_tree(LABELS, ask_j, stop_groups=2)
    assert prompts_t == prompts_j and len(layers) == 2
    paths = tgen.tree_to_paths(LABELS, layers)
    assert paths == jgen.tree_to_paths(LABELS, layers)
    tree = tgen.assign_level_ids(paths)
    assert tree == jgen.assign_level_ids(paths)
    path = tgen.save_tree_json(tree, str(tmp_path / "tree.json"))
    with open(path) as f:
        assert json.load(f) == tree
    mapping, _ = read_tree_annotation(tree, tree_level=len(paths["chair"]))
    assert all(c >= 1 for c in find_max_level(mapping))
    assert paths["lamp"] == ["indoor", "soft things" if "lamp" in forget else "lighting"]


def test_one_layer_and_parser_match_jax():
    ask, _ = stub_client(("blinds",))
    one = tgen.generate_tree_one_layer(LABELS, ask, max_groups=4)
    assert one == jgen.generate_tree_one_layer(LABELS, stub_client(("blinds",))[0], 4)
    assert one["furniture"] == ["chair", "sofa", "table", "bed"]   # deduplicated
    assert "not a label" not in sum(one.values(), [])
    with pytest.raises(ValueError, match="no JSON object"):
        tgen._parse_json_block("no braces here")
    text = 'x {"a": ["b"]} y'
    assert tgen._parse_json_block(text) == jgen._parse_json_block(text)


def test_unassigned_labels_land_in_other():
    """A client that never places a label: after the retries it lands in
    ``other`` on both sides."""
    def ask(prompt):
        if "not assigned" in prompt:
            return json.dumps({"other things": []})
        return json.dumps({"all": [x for x in LABELS if x != "bed"]})

    assert tgen.generate_tree_one_layer(LABELS, ask, 3) == \
        jgen.generate_tree_one_layer(LABELS, ask, 3)
    assert tgen.generate_tree_one_layer(LABELS, ask, 3)["other"] == ["bed"]


def test_openai_client_is_imported_only_when_asked():
    """``make_openai_client`` imports ``openai`` when called; here it is
    not installed, and both packages raise the same way."""
    try:
        import openai  # noqa: F401
        pytest.skip("openai is installed: building a client would not fail")
    except ImportError:
        pass
    for gen in (tgen, jgen):
        with pytest.raises(ImportError):
            gen.make_openai_client(api_key="unused")
