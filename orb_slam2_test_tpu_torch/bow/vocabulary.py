"""Hierarchical BoW vocabulary over 256-bit ORB descriptors.

Port of orb_slam2_test_tpu/bow/vocabulary.py (reference: DBoW2's
TemplatedVocabulary<FORB>). The k-ary tree is flat arrays: node
descriptors [n_nodes, 8] uint32, a children table [n_nodes, k] int32
(-1 pad), leaf word ids and idf weights. `transform` is `depth` rounds
of a k-way Hamming argmin over a node's children, batched over the
descriptors; the distances are exact integer popcounts.

The arrays stay numpy in the dataclass (the file formats) and go to a
device once, at the first `on(device)` (the Tracker attaches the
vocabulary to its device); descriptors there are int32 bit patterns.
Building the tree (hierarchical binary k-means, numpy with a seeded
`default_rng`, as DBoW2's `create` does offline) and the file formats
(a compact npz, and DBoW2's text format for parity with ORBvoc.txt)
are host code; the idf weights `transform` the training set on a
device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# the distance of a missing child: above any Hamming distance (<= 256)
_NO_CHILD = 4096


@dataclasses.dataclass(eq=False)
class Vocabulary:
    """Flat-array vocabulary tree.

    node_desc     [n_nodes, 8] uint32 — node cluster centers
    node_children [n_nodes, k] int32 — children ids (-1 pad); rows of
                  leaves are all -1
    node_is_leaf  [n_nodes] bool
    leaf_word     [n_nodes] int32 — word id for leaves, -1 otherwise
    word_weight   [n_words] float32 — idf weights
    k, depth      branching factor / levels
    """

    node_desc: np.ndarray
    node_children: np.ndarray
    node_is_leaf: np.ndarray
    leaf_word: np.ndarray
    word_weight: np.ndarray
    k: int
    depth: int
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    def on(self, device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(node_desc int32 bit patterns, node_children int32, leaf_word
        int32) on `device`, uploaded at the first call for that device."""
        device = torch.device(device)
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (np.asarray(self.node_desc, np.uint32).view(np.int32),
                          np.asarray(self.node_children, np.int32),
                          np.asarray(self.leaf_word, np.int32))
            )
        return self._on[key]


def _unpack(desc: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 256] uint8 bits (little-endian within word,
    matching ops.brief's packing)."""
    desc = np.asarray(desc).view(np.uint32)
    b = np.zeros((len(desc), 256), np.uint8)
    for w in range(8):
        word = desc[:, w]
        for i in range(32):
            b[:, w * 32 + i] = (word >> i) & 1
    return b


def _pack(bits: np.ndarray) -> np.ndarray:
    """[N, 256] bits -> [N, 8] uint32 (the inverse of `_unpack`)."""
    out = np.zeros((len(bits), 8), np.uint32)
    for w in range(8):
        for i in range(32):
            out[:, w] |= bits[:, w * 32 + i].astype(np.uint32) << np.uint32(i)
    return out


def _binary_kmeans(bits: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """k-means on binary vectors with majority-vote centroids.
    Returns (centroids [k', 256], assign [N]) with k' <= k."""
    n = len(bits)
    k = min(k, n)
    sel = rng.choice(n, size=k, replace=False)
    cent = bits[sel].astype(np.uint8)
    fb = bits.astype(np.float32)
    for _ in range(iters):
        # hamming distance via dot products on {0,1}: d = a + c - 2ac
        fc = cent.astype(np.float32)
        cross = fb @ fc.T  # [N, k]
        d = fb.sum(1, keepdims=True) + fc.sum(1)[None, :] - 2.0 * cross
        assign = d.argmin(1)
        new = []
        for c in range(len(cent)):
            m = assign == c
            if not m.any():
                continue
            new.append((fb[m].mean(0) >= 0.5).astype(np.uint8))
        cent = np.stack(new)
    fc = cent.astype(np.float32)
    cross = fb @ fc.T
    d = fb.sum(1, keepdims=True) + fc.sum(1)[None, :] - 2.0 * cross
    return cent, d.argmin(1)


def build_tree(
    train_desc: np.ndarray,  # [N, 8] uint32 (or int32 bit patterns)
    k: int = 10,
    depth: int = 4,
    seed: int = 0,
) -> Vocabulary:
    """Hierarchical binary k-means (DBoW2::create), host numpy: the tree,
    every word weighted 1. `depth` counts levels of internal splits; the
    number of words is at most k^depth."""
    train_desc = np.ascontiguousarray(train_desc).view(np.uint32)
    rng = np.random.default_rng(seed)
    bits = _unpack(train_desc)

    node_desc = [np.zeros(256, np.uint8)]  # root (unused descriptor)
    node_children: list[list[int]] = [[]]
    node_level = [0]
    stack = [(0, np.arange(len(bits)))]
    while stack:
        nid, idx = stack.pop()
        lvl = node_level[nid]
        if lvl >= depth or len(idx) <= 1:
            continue
        cents, assign = _binary_kmeans(bits[idx], k, rng)
        for c in range(len(cents)):
            cid = len(node_desc)
            node_desc.append(cents[c])
            node_children.append([])
            node_level.append(lvl + 1)
            node_children[nid].append(cid)
            sub = idx[assign == c]
            if lvl + 1 < depth and len(sub) > 1:
                stack.append((cid, sub))

    n_nodes = len(node_desc)
    children = np.full((n_nodes, k), -1, np.int32)
    is_leaf = np.ones(n_nodes, bool)
    for i, ch in enumerate(node_children):
        if ch:
            children[i, : len(ch)] = ch
            is_leaf[i] = False
    is_leaf[0] = False

    leaf_word = np.full(n_nodes, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    leaf_word[leaves] = np.arange(len(leaves), dtype=np.int32)

    return Vocabulary(
        node_desc=_pack(np.stack(node_desc)),
        node_children=children,
        node_is_leaf=is_leaf,
        leaf_word=leaf_word,
        word_weight=np.ones(len(leaves), np.float32),
        k=k,
        depth=depth,
    )


def idf_weights(voc: Vocabulary, train_desc: np.ndarray,
                device: torch.device | str = "cuda") -> np.ndarray:
    """idf weights of voc's words from the training set: documents are
    chunks of ~1000 descriptors, approximating per-image statistics. The
    descriptors' `transform` runs on `device`."""
    train_desc = np.ascontiguousarray(train_desc).view(np.uint32)
    desc = torch.from_numpy(train_desc.view(np.int32)).to(device)
    words, _ = transform(voc, desc, torch.ones(len(train_desc), dtype=torch.bool,
                                                device=desc.device))
    words = words.cpu().numpy()
    n_docs = max(len(train_desc) // 1000, 1)
    doc_ids = np.minimum(np.arange(len(train_desc)) // 1000, n_docs - 1)
    n_i = np.zeros(voc.n_words, np.float32)
    for d in range(n_docs):
        uw = np.unique(words[doc_ids == d])
        uw = uw[uw >= 0]
        n_i[uw] += 1.0
    idf = np.log(n_docs / np.maximum(n_i, 1.0)) + 1e-3
    return idf.astype(np.float32)


def build_vocabulary(
    train_desc: np.ndarray,  # [N, 8] uint32 (or int32 bit patterns)
    k: int = 10,
    depth: int = 4,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Vocabulary:
    """`build_tree`, then `idf_weights` on `device` (the card unless the
    caller asks for another)."""
    voc = build_tree(train_desc, k, depth, seed)
    voc.word_weight = idf_weights(voc, train_desc, device)
    return voc


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 bit pattern, exact, as int64 (SWAR on the
    pattern widened to an unsigned 32-bit value in int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def transform(
    voc: Vocabulary,
    desc: torch.Tensor,  # [B, 8] int32 bit patterns
    valid: torch.Tensor,  # [B] bool
    node_level_out: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched descriptor -> word lookup on desc's device.

    Returns (word_ids [B] int32, -1 where invalid; mid_node [B] int32,
    the tree node `node_level_out` levels below the root, DBoW2's
    FeatureVector grouping node, -1 where invalid). Ties between
    children go to the first, as jnp.argmin does."""
    node_desc, node_children, leaf_word = voc.on(desc.device)
    B = desc.shape[0]
    cur = torch.zeros(B, dtype=torch.int64, device=desc.device)
    mid = cur
    for lvl in range(voc.depth):
        ch = node_children[cur].to(torch.int64)  # [B, k]
        cdesc = node_desc[ch.clamp(min=0)]  # [B, k, 8]
        d = popcount32(cdesc ^ desc[:, None, :]).sum(-1)  # [B, k]
        d = torch.where(ch >= 0, d, _NO_CHILD)
        nxt = ch.gather(1, d.argmin(dim=-1, keepdim=True))[:, 0]
        # stop at leaves (variable-depth branches): keep cur if no child
        cur = torch.where((ch >= 0).any(-1), nxt, cur)
        if lvl + 1 == node_level_out:
            mid = cur
    words = torch.where(valid, leaf_word[cur], -1).to(torch.int32)
    return words, torch.where(valid, mid, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Native npz vocabulary format (fast load; the DBoW2 text format below
# exists for parity with the reference's ORBvoc.txt)
# ---------------------------------------------------------------------------


def save_vocabulary_npz(voc: Vocabulary, path: str) -> None:
    """Compact binary vocabulary artifact, the JAX package's format."""
    np.savez_compressed(
        path,
        node_desc=voc.node_desc,
        node_children=voc.node_children,
        node_is_leaf=voc.node_is_leaf,
        leaf_word=voc.leaf_word,
        word_weight=voc.word_weight,
        k=np.int32(voc.k),
        depth=np.int32(voc.depth),
    )


def load_vocabulary_npz(path: str) -> Vocabulary:
    with np.load(path) as z:
        return Vocabulary(
            node_desc=z["node_desc"],
            node_children=z["node_children"],
            node_is_leaf=z["node_is_leaf"],
            leaf_word=z["leaf_word"],
            word_weight=z["word_weight"],
            k=int(z["k"]),
            depth=int(z["depth"]),
        )


# the JAX package's packaged artifact (k = 10, L = 6, ~794k leaf words,
# trained with this framework's own BRIEF pattern), read by its path
DEFAULT_VOCABULARY_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "orb_slam2_test_tpu", "data", "vocab_k10_L6.npz"
)


def load_vocabulary(path: str) -> Vocabulary:
    """Load a vocabulary by extension: .npz (native) or DBoW2 text."""
    if path.endswith(".npz"):
        return load_vocabulary_npz(path)
    return load_text_vocabulary(path)


def default_vocabulary() -> Vocabulary:
    """The packaged vocabulary (reference: System loads ORBvoc.txt at
    startup). Raises FileNotFoundError if the artifact is absent."""
    path = os.path.normpath(DEFAULT_VOCABULARY_PATH)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no packaged vocabulary at {path}; train one with build_vocabulary "
            "or pass --no-vocabulary"
        )
    return load_vocabulary_npz(path)


# ---------------------------------------------------------------------------
# DBoW2 text format (ORBvoc.txt): first line "k L scoring weighting";
# then one line per non-root node (in BFS order):
#   parent_id is_leaf d0 d1 ... d31 weight
# with d* the 32 descriptor bytes.
# ---------------------------------------------------------------------------


def save_text_vocabulary(voc: Vocabulary, path: str) -> None:
    bits = _unpack(voc.node_desc)
    byts = np.packbits(
        bits.reshape(len(bits), 32, 8), axis=-1, bitorder="little"
    )[..., 0]  # [n, 32] bytes, little-endian bit order within byte
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        parent = np.zeros(len(voc.node_desc), np.int32)
        for i, ch in enumerate(voc.node_children):
            for c in ch:
                if c >= 0:
                    parent[c] = i
        for nid in range(1, len(voc.node_desc)):
            is_leaf = int(voc.node_is_leaf[nid])
            w = (
                float(voc.word_weight[voc.leaf_word[nid]])
                if is_leaf and voc.leaf_word[nid] >= 0
                else 0.0
            )
            ds = " ".join(str(int(b)) for b in byts[nid])
            f.write(f"{parent[nid]} {is_leaf} {ds} {w}\n")


def load_text_vocabulary(path: str) -> Vocabulary:
    """Parse the DBoW2 text vocabulary format
    (ORBVocabulary::loadFromTextFile) with the native C++ parser
    (native/vocab_loader.cc, built with g++ at first use), or the
    line-by-line Python parser when no compiler is available."""
    from orb_slam2_test_tpu_torch.utils.native import parse_vocab_text

    parsed = parse_vocab_text(path)
    if parsed is None:
        return _load_text_vocabulary_py(path)
    k, depth, byts, parent, is_leaf, weight = parsed
    n = len(parent)
    # the file bytes are the packed layout: little-endian bits within a
    # byte, little-endian bytes within a uint32 (== _pack(_unpack))
    node_desc = np.ascontiguousarray(byts).view(np.uint32)

    # children[p, slot] in file order (a stable sort preserves it)
    children = np.full((n, k), -1, np.int32)
    nid = np.arange(1, n, dtype=np.int32)
    p = parent[1:]
    order = np.argsort(p, kind="stable")
    sp, sn = p[order], nid[order]
    group_start = np.searchsorted(sp, sp, side="left")
    slot = np.arange(len(sp)) - group_start
    keep = slot < k
    children[sp[keep], slot[keep]] = sn[keep]

    leaf_word = np.full(n, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    leaf_word[leaves] = np.arange(len(leaves), dtype=np.int32)
    return Vocabulary(
        node_desc=node_desc,
        node_children=children,
        node_is_leaf=is_leaf,
        leaf_word=leaf_word,
        word_weight=weight[leaves].astype(np.float32),
        k=k,
        depth=depth,
    )


def _load_text_vocabulary_py(path: str) -> Vocabulary:
    """Pure-Python parser (the fallback without a C++ compiler)."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaf_flags, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(int(parts[1]))
            descs.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))

    n = len(parents) + 1  # + root
    byts = np.zeros((n, 32), np.uint8)
    byts[1:] = np.asarray(descs, np.uint8)
    bits = np.unpackbits(byts[:, :, None], axis=2, bitorder="little")
    bits = bits.reshape(n, 256)
    node_desc = _pack(bits)

    children = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for i, p in enumerate(parents):
        nid = i + 1
        children[p, counts[p]] = nid
        counts[p] += 1
    is_leaf = np.asarray([False] + [bool(x) for x in leaf_flags])
    leaf_word = np.full(n, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    leaf_word[leaves] = np.arange(len(leaves), dtype=np.int32)
    w = np.zeros(len(leaves), np.float32)
    for j, nid in enumerate(leaves):
        w[j] = weights[nid - 1]
    return Vocabulary(
        node_desc=node_desc,
        node_children=children,
        node_is_leaf=is_leaf,
        leaf_word=leaf_word,
        word_weight=w,
        k=k,
        depth=depth,
    )
