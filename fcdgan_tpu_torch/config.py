"""Command-line parsing of dataclass configs.

Copy of ``parse_cli`` from the JAX package's ``config.py`` (:290-345): every
dataclass field becomes ``--field-name``, parsed by its resolved annotation
(bools accept 1/true/yes, tuples are comma-separated and cast per element).
"""

from __future__ import annotations

import argparse
import dataclasses
import types
import typing


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _tuple_parser(tp):
    """Comma-separated tuple parser casting per the annotation's element
    types (``Tuple[int, int]`` casts each to int, ``Tuple[float, ...]`` all to
    float; untyped tuples infer int-vs-float per token)."""
    el = typing.get_args(tp)

    def parse(s: str):
        toks = [t for t in s.split(",") if t != ""]
        if el and el[-1] is Ellipsis:
            return tuple(el[0](t) for t in toks)
        if el and len(el) == len(toks):
            return tuple(cast(t) for cast, t in zip(el, toks))
        return tuple(float(v) if "." in v else int(v) for v in toks)

    return parse


def _unwrap_optional(tp):
    """Optional[X] / X | None -> X (the non-None member)."""
    if typing.get_origin(tp) in (typing.Union, types.UnionType):
        non_none = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(non_none) == 1:
            return non_none[0]
    return tp


def parse_cli(config_cls, argv=None):
    """Build a ``config_cls`` instance from CLI flags."""
    hints = typing.get_type_hints(config_cls)
    ap = argparse.ArgumentParser(description=config_cls.__doc__)
    for f in dataclasses.fields(config_cls):
        name = "--" + f.name.replace("_", "-")
        tp = _unwrap_optional(hints[f.name])
        if tp is bool:
            parser = _parse_bool
        elif typing.get_origin(tp) is tuple or tp is tuple:
            parser = _tuple_parser(tp)
        elif tp in (int, float, str):
            parser = tp
        else:
            raise TypeError(f"{config_cls.__name__}.{f.name}: unsupported CLI field "
                            f"type {hints[f.name]!r}")
        ap.add_argument(name, type=parser, default=f.default)
    args = ap.parse_args(argv)
    return config_cls(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(config_cls)})
