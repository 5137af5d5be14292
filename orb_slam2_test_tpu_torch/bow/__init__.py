"""Bag-of-words place recognition: vocabulary tree + batched transform."""

from orb_slam2_test_tpu_torch.bow.vocabulary import (
    Vocabulary,
    build_vocabulary,
    load_text_vocabulary,
    save_text_vocabulary,
)
