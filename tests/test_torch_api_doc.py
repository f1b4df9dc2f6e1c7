"""docs/API_torch.md, the port's API reference: generated by
docs/gen_api_torch.py, it lists exactly the port's ``__all__`` and a fresh
generation gives the checked-in file."""

import importlib.util
import os
import re

import incrementalinference_torch as it

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = os.path.join(ROOT, "docs", "API_torch.md")


def _generator():
    path = os.path.join(ROOT, "docs", "gen_api_torch.py")
    spec = importlib.util.spec_from_file_location("gen_api_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_page_lists_exactly_the_ports_all():
    text = open(PAGE).read()
    names = re.findall(r"^### `([A-Za-z_][A-Za-z0-9_]*)", text, re.M)
    assert len(names) == len(set(names)) == len(it.__all__)
    assert set(names) == set(it.__all__)


def test_a_fresh_generation_is_the_checked_in_page():
    assert _generator().render() == open(PAGE).read()


def test_the_page_ends_with_the_deliberate_departures():
    text = open(PAGE).read()
    head, tail = text.split(
        "\n## Where the port departs from the reference on purpose\n")
    assert "\n## " not in tail
    lines = [ln for ln in tail.splitlines() if ln.startswith("- ")]
    assert len(lines) == len(_generator().DEPARTURES) >= 7
    for word in ("device=", "full_precision", "threefry", "QR",
                 "_member_factors", "keys.cdf", "one-hot", "warmstart"):
        assert word in tail, word
