"""Collectives: the reference runs on one device and joins no group."""

from __future__ import annotations


def all_reduce(tensor, group=None):
    raise RuntimeError("the reference runs on one device; it has no process group")
