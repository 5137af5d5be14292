// Fast DBoW2 text-vocabulary parser.
//
// The reference's ORBVocabulary::loadFromTextFile (a ~145 MB,
// ~1.1M-line text parse) is its slowest init step even in C++ with
// iostreams; a pure-Python line parser takes minutes. This parser
// mmap()s the file and scans it with branch-light custom tokenizers.
//
// A copy of orb_slam2_test_tpu/native/src/vocab_loader.cc, kept inside
// the PyTorch port so that the port needs nothing of the JAX package.
// Exposed as a C API for ctypes (orb_slam2_test_tpu_torch/utils/native.py,
// which builds it with g++ into orb_slam2_test_tpu_torch/_build/); the
// Python side reassembles the flat-array Vocabulary (bow/vocabulary.py)
// from the returned buffers.
//
// Line format (after the "k L scoring weighting" header), one node per
// line, file order defines node ids starting at 1 (0 = root):
//   <parent_id> <is_leaf> <32 descriptor bytes> <weight>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  // non-negative integer; -1 at EOF, -2 on a non-digit byte (so a
  // malformed file fails instead of spinning without advancing)
  long parse_uint() {
    skip_ws();
    if (p >= end) return -1;
    if (*p < '0' || *p > '9') return -2;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      ++p;
    }
    return v;
  }

  double parse_float() {
    skip_ws();
    char* q = nullptr;
    double v = strtod(p, &q);
    p = q;
    return v;
  }
};

}  // namespace

extern "C" {

struct VocabData {
  int64_t n_nodes;  // including the root (id 0, zero row)
  int32_t k;
  int32_t depth;
  uint8_t* desc;    // [n_nodes * 32]
  int32_t* parent;  // [n_nodes]; root = -1
  uint8_t* is_leaf; // [n_nodes]
  float* weight;    // [n_nodes]
};

VocabData* vocab_load_text(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return nullptr;
  }
  const char* data = static_cast<const char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return nullptr;

  Cursor c{data, data + st.st_size};
  long k = c.parse_uint();
  long depth = c.parse_uint();
  c.parse_uint();  // scoring type (ignored: L1 assumed, as reference)
  c.parse_uint();  // weighting type (ignored: TF-IDF assumed)
  if (k <= 0 || depth <= 0) {
    munmap(const_cast<char*>(data), st.st_size);
    return nullptr;
  }

  // upper bound on node count: (k^(depth+1)-1)/(k-1); grow instead
  int64_t cap = 1 << 16;
  int64_t n = 1;  // root
  auto* desc = static_cast<uint8_t*>(malloc(cap * 32));
  auto* parent = static_cast<int32_t*>(malloc(cap * 4));
  auto* leaf = static_cast<uint8_t*>(malloc(cap));
  auto* weight = static_cast<float*>(malloc(cap * 4));
  memset(desc, 0, 32);
  parent[0] = -1;
  leaf[0] = 0;
  weight[0] = 0.f;

  bool ok = true;
  for (;;) {
    long pid = c.parse_uint();
    if (pid == -1) break;  // EOF
    if (pid == -2) {
      ok = false;
      break;
    }
    if (n == cap) {
      cap *= 2;
      desc = static_cast<uint8_t*>(realloc(desc, cap * 32));
      parent = static_cast<int32_t*>(realloc(parent, cap * 4));
      leaf = static_cast<uint8_t*>(realloc(leaf, cap));
      weight = static_cast<float*>(realloc(weight, cap * 4));
    }
    long is_leaf = c.parse_uint();
    if (is_leaf < 0) {
      ok = false;
      break;
    }
    uint8_t* d = desc + n * 32;
    for (int b = 0; b < 32; ++b) {
      long v = c.parse_uint();
      if (v < 0 || v > 255) {
        ok = false;
        break;
      }
      d[b] = static_cast<uint8_t>(v);
    }
    if (!ok) break;
    parent[n] = static_cast<int32_t>(pid);
    leaf[n] = static_cast<uint8_t>(is_leaf != 0);
    weight[n] = static_cast<float>(c.parse_float());
    ++n;
  }
  munmap(const_cast<char*>(data), st.st_size);
  if (!ok || n <= 1) {
    free(desc);
    free(parent);
    free(leaf);
    free(weight);
    return nullptr;
  }

  auto* out = static_cast<VocabData*>(malloc(sizeof(VocabData)));
  out->n_nodes = n;
  out->k = static_cast<int32_t>(k);
  out->depth = static_cast<int32_t>(depth);
  out->desc = desc;
  out->parent = parent;
  out->is_leaf = leaf;
  out->weight = weight;
  return out;
}

void vocab_free(VocabData* v) {
  if (!v) return;
  free(v->desc);
  free(v->parent);
  free(v->is_leaf);
  free(v->weight);
  free(v);
}

}  // extern "C"
