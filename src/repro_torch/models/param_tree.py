"""A module that holds a reference parameter tree under its own names.

The reference keeps a model's parameters in nested dicts and lists
(``{"mlp": [{"w": ..., "b": ...}, ...], "gru": {"wx": ...}}``).
:class:`ParamTree` holds the same tree as an ``nn.Module``: a dict becomes
a submodule, a list an ``nn.ModuleList``, an array an ``nn.Parameter``, so
the parameter names are the reference's tree paths joined by dots
(``mlp.0.w``, ``gru.wx``) and ``train.checkpoint`` writes the reference's
keys (``mlp/0/w``).  Attribute access follows the tree: ``p.mlp[0].w``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["ParamTree", "tree_of", "spec_tree"]


def _node(value, device):
    if isinstance(value, dict):
        return ParamTree(value, device=device)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList([_node(v, device) for v in value])
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
    return nn.Parameter(t.to(device) if device is not None else t)


class ParamTree(nn.Module):
    """``tree``: nested dicts and lists of tensors or numpy arrays (numpy
    values are copied); on ``device`` when given, else where they are."""

    def __init__(self, tree: dict, *, device=None):
        super().__init__()
        for key, value in tree.items():
            node = _node(value, device)
            if isinstance(node, nn.Parameter):
                self.register_parameter(key, node)
            else:
                self.add_module(key, node)


def tree_of(module: nn.Module, leaf=lambda p: p):
    """The module's parameters as the reference's nested dicts and lists,
    each leaf ``leaf(parameter)``."""
    if isinstance(module, nn.ModuleList):
        return [tree_of(m, leaf) for m in module]
    out = {n: leaf(p) for n, p in module.named_parameters(recurse=False)}
    out.update({n: tree_of(m, leaf) for n, m in module.named_children()})
    return out


def spec_tree(module: nn.Module, rules, sharded_tables: tuple[str, ...] = ()):
    """The reference's ``param_specs``: every leaf replicated (``rules.spec()``)
    but the named top-level tables, row-sharded over "model"."""
    specs = tree_of(module, lambda _: rules.spec())
    for name in sharded_tables:
        specs[name] = rules.spec("model", None)
    return specs
