"""Placement of the persistent compilation cache used by the entry points."""

import os

import jax
import pytest

from elimaloc_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", [None, "/some/shared/jax-cache"],
                         ids=["unset", "set"])
def test_cache_placement(monkeypatch, env_dir):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)

    path = compile_cache.enable_compile_cache()

    if env_dir is None:
        # a fixed directory inside the checkout, set in code
        assert path == os.path.join(compile_cache.CHECKOUT_ROOT, ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", path)]
        assert compile_cache.enable_compile_cache() == path  # stable
    else:
        # the environment wins and the code sets no other directory
        assert path == env_dir
        assert updates == []
        assert compile_cache.cache_dir_to_set() is None


def test_default_cache_dir_is_ignored_by_git():
    root = compile_cache.CHECKOUT_ROOT
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    rel = os.path.relpath(compile_cache.DEFAULT_DIR, root)
    assert rel + "/" in ignored
