"""Bag-of-words place recognition: vocabulary tree + batched transform."""
