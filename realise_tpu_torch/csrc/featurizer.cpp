// Native batch featurizer: WordPiece tokenization + fixed-shape batch
// assembly with a C ABI for ctypes.
//
// The reference pays tokenizer + pinyin cost inside the training loop in
// Python for every step (reference: src/run.py:68-101 make_features +
// src/models.py:797-804 build_batch; the thread-prefetch runner
// run_speedup.py exists to hide it). This library removes the remaining
// Python-side cost of the AOT pipeline: UTF-8 decode, BERT basic
// tokenization (CJK splitting, punctuation splitting, lowercasing),
// greedy longest-match WordPiece, and direct emission into caller-provided
// int32 batch buffers (src_idx/masks/loss_masks/lengths/tokens_size —
// run.py:68-101 semantics). Pinyin features stay a numpy table gather.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared at first use, by
// realise_tpu_torch/ops/kernels/_build.py (emits
// build/realise_tpu_torch/librealise_featurizer.so).
// Python binding: realise_tpu_torch/data/native.py (ctypes).

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- UTF-8
// Decode UTF-8 into codepoints; malformed bytes (bad lead, missing or
// invalid continuation) become U+FFFD consuming ONE byte, so a stray
// 0xC3 before a valid 'A' never swallows the 'A' (the Python codec's
// 'replace' behavior the fallback path exhibits).
std::vector<uint32_t> decode_utf8(const char* s, std::vector<std::string>* chars) {
  std::vector<uint32_t> cps;
  size_t i = 0, n = std::strlen(s);
  auto cont = [&](size_t k) {
    return k < n && ((unsigned char)s[k] & 0xC0) == 0x80;
  };
  while (i < n) {
    unsigned char c = s[i];
    uint32_t cp = 0xFFFD;
    size_t len = 1;
    if (c < 0x80) {
      cp = c;
    } else if ((c >> 5) == 0x6 && cont(i + 1)) {
      cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
      len = 2;
    } else if ((c >> 4) == 0xE && cont(i + 1) && cont(i + 2)) {
      cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
      len = 3;
    } else if ((c >> 3) == 0x1E && cont(i + 1) && cont(i + 2) && cont(i + 3)) {
      cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
           ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
      len = 4;
    }
    cps.push_back(cp);
    if (chars) chars->emplace_back(s + i, len);
    i += len;
  }
  return cps;
}

std::string encode_utf8(uint32_t cp) {
  std::string out;
  if (cp < 0x80) {
    out += (char)cp;
  } else if (cp < 0x800) {
    out += (char)(0xC0 | (cp >> 6));
    out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += (char)(0xE0 | (cp >> 12));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  } else {
    out += (char)(0xF0 | (cp >> 18));
    out += (char)(0x80 | ((cp >> 12) & 0x3F));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  }
  return out;
}

// ------------------------------------------------------ char classifiers
// Mirrors realise_tpu.text.tokenizer (BERT BasicTokenizer semantics).
bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

bool is_space(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0xA0 ||
         cp == 0x1680 || (cp >= 0x2000 && cp <= 0x200A) || cp == 0x202F ||
         cp == 0x205F || cp == 0x3000;
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  return cp < 0x20 || cp == 0x7F || (cp >= 0x80 && cp <= 0x9F) ||
         cp == 0x200B || cp == 0xFEFF;
}

bool is_punct(uint32_t cp) {
  // Mirrors tokenizer.py _is_punctuation: the BERT ASCII ranges plus
  // Unicode category P*. The block ranges below carve out their non-P
  // members (verified against unicodedata per codepoint): symbols like
  // 〇 U+3007 (Nl), 々 U+3005 (Lm), fullwidth ＋＜＝＞＾｀｜～ (S*),
  // ⁄ U+2044 / ⁒ U+2052 (Sm), and the Zl/Zp line separators must NOT
  // split as punctuation — the Python path keeps them inside words.
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  // Latin-1 P*: ¡ § « ¶ · » ¿
  if (cp == 0xA1 || cp == 0xA7 || cp == 0xAB || cp == 0xB6 || cp == 0xB7 ||
      cp == 0xBB || cp == 0xBF)
    return true;
  if (cp >= 0x2000 && cp <= 0x206F) {
    if (is_space(cp)) return false;
    // Cf format chars (stripped upstream anyway), Zl/Zp, ⁄ ⁒.
    if ((cp >= 0x200B && cp <= 0x200F) || (cp >= 0x2028 && cp <= 0x202E) ||
        cp == 0x2044 || cp == 0x2052 || cp >= 0x2060)
      return false;
    return true;
  }
  if (cp >= 0x3001 && cp <= 0x303F) {
    if ((cp >= 0x3004 && cp <= 0x3007) || (cp >= 0x3012 && cp <= 0x3013) ||
        (cp >= 0x3020 && cp <= 0x302F) || (cp >= 0x3031 && cp <= 0x303C) ||
        cp >= 0x303E)
      return false;
    return true;
  }
  if (cp >= 0xFF00 && cp <= 0xFF65) {
    if (cp == 0xFF00 || cp == 0xFF04 || cp == 0xFF0B ||
        (cp >= 0xFF1C && cp <= 0xFF1E) || cp == 0xFF3E || cp == 0xFF40 ||
        cp == 0xFF5C || cp == 0xFF5E)
      return false;
    return (cp <= 0xFF0F) || (cp >= 0xFF1A && cp <= 0xFF20) ||
           (cp >= 0xFF3B && cp <= 0xFF40) || (cp >= 0xFF5B);
  }
  return cp >= 0xFE30 && cp <= 0xFE4F;
}

uint32_t to_lower(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 32;  // Latin-1
  return cp;
}

// ------------------------------------------------------------- tokenizer
struct Featurizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 0, cls_id = 0, sep_id = 0;
  int max_input_chars_per_word = 100;
  bool do_lower = true;

  bool load_ok = false;

  explicit Featurizer(const char* vocab_path) {
    std::ifstream f(vocab_path);
    if (!f.is_open()) return;  // rtf_create reports failure as NULL
    std::string line;
    int32_t idx = 0;
    while (std::getline(f, line)) {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      // operator[]: last occurrence wins for duplicated lines, matching
      // the Python loader's dict assignment (tokenizer.py load_vocab).
      vocab[line] = idx++;
    }
    auto get = [&](const char* t) {
      auto it = vocab.find(t);
      return it == vocab.end() ? (int32_t)-1 : it->second;
    };
    unk_id = get("[UNK]");
    cls_id = get("[CLS]");
    sep_id = get("[SEP]");
    // A vocab without the specials must fail fast (rtf_create -> NULL),
    // not silently emit id 0 for every un-tokenizable word — the Python
    // path raises KeyError on first use.
    load_ok = !vocab.empty() && unk_id >= 0 && cls_id >= 0 && sep_id >= 0;
  }

  // Basic tokenization: cleanup + CJK/punct splitting + lowercase.
  // Each output token also carries its source-char count.
  void basic_tokenize(const char* text,
                      std::vector<std::string>* words) const {
    std::vector<uint32_t> cps = decode_utf8(text, nullptr);
    std::string cur;
    auto flush = [&]() {
      if (!cur.empty()) {
        words->push_back(cur);
        cur.clear();
      }
    };
    for (uint32_t cp : cps) {
      if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
      if (is_space(cp)) {
        flush();
        continue;
      }
      if (do_lower) cp = to_lower(cp);
      if (is_cjk(cp) || is_punct(cp)) {
        flush();
        words->push_back(encode_utf8(cp));
      } else {
        cur += encode_utf8(cp);
      }
    }
    flush();
  }

  // Greedy longest-match WordPiece on one basic token.
  void wordpiece(const std::string& word, std::vector<int32_t>* ids,
                 std::vector<int32_t>* sizes) const {
    std::vector<std::string> chars;
    decode_utf8(word.c_str(), &chars);
    if ((int)chars.size() > max_input_chars_per_word) {
      ids->push_back(unk_id);
      sizes->push_back(1);
      return;
    }
    size_t start = 0;
    std::vector<std::pair<int32_t, int32_t>> pieces;  // (id, char span)
    while (start < chars.size()) {
      size_t end = chars.size();
      int32_t found = -1;
      size_t found_end = start;
      while (start < end) {
        std::string sub = start > 0 ? "##" : "";
        for (size_t k = start; k < end; ++k) sub += chars[k];
        auto it = vocab.find(sub);
        if (it != vocab.end()) {
          found = it->second;
          found_end = end;
          break;
        }
        --end;
      }
      if (found < 0) {
        ids->push_back(unk_id);
        // UNK eats the whole word, but the reference records
        // tokens_size=1 for UNK (data_process/dataset.py:60-69).
        sizes->push_back(1);
        return;
      }
      pieces.emplace_back(found, (int32_t)(found_end - start));
      start = found_end;
    }
    for (auto& pr : pieces) {
      ids->push_back(pr.first);
      sizes->push_back(pr.second);
    }
  }

  // Encode one sentence: [CLS] pieces [SEP], plus per-piece source widths.
  void encode(const char* text, std::vector<int32_t>* ids,
              std::vector<int32_t>* sizes) const {
    std::vector<std::string> words;
    basic_tokenize(text, &words);
    ids->push_back(cls_id);
    for (auto& w : words) wordpiece(w, ids, sizes);
    ids->push_back(sep_id);
  }
};

}  // namespace

extern "C" {

void* rtf_create(const char* vocab_path) {
  auto* f = new Featurizer(vocab_path);
  if (!f->load_ok) {  // missing/empty vocab: fail fast, not all-zero ids
    delete f;
    return nullptr;
  }
  return f;
}

// do_lower_case=0 keeps case (the Python tokenizer's cased mode; the
// caller must then also skip its host-side lower/accent normalization —
// realise_tpu/data/native.py _normalize).
void* rtf_create_ex(const char* vocab_path, int do_lower) {
  auto* f = static_cast<Featurizer*>(rtf_create(vocab_path));
  if (f) f->do_lower = do_lower != 0;
  return f;
}

void rtf_destroy(void* h) { delete static_cast<Featurizer*>(h); }

int rtf_vocab_size(void* h) {
  return (int)static_cast<Featurizer*>(h)->vocab.size();
}

// Featurize a batch of n sentences into fixed-shape int32 buffers
// (row-major [n, max_len]); lengths is [n]. Returns 0 on success.
// Semantics match run.py:68-101: truncate to max_len, masks over
// CLS+sentence+SEP, loss_masks over positions 1..length.
int rtf_encode_batch(void* handle, const char** sents, int n, int max_len,
                     int32_t* src_idx, int32_t* masks, int32_t* loss_masks,
                     int32_t* lengths, int32_t* tokens_size) {
  auto* f = static_cast<Featurizer*>(handle);
  for (int i = 0; i < n; ++i) {
    std::vector<int32_t> ids, sizes;
    f->encode(sents[i], &ids, &sizes);
    int32_t len = (int32_t)ids.size() - 2;  // without CLS/SEP
    lengths[i] = len;
    // Truncation keeps BERT layout: [CLS] + (max_len-2) content + [SEP],
    // with loss over content positions only — identical to the Python
    // featurizer (data/features.py featurize).
    bool truncated = (int)ids.size() > max_len;
    int32_t content = truncated ? max_len - 2 : len;
    int32_t* row = src_idx + (size_t)i * max_len;
    int32_t* mrow = masks + (size_t)i * max_len;
    int32_t* lrow = loss_masks + (size_t)i * max_len;
    int32_t* trow = tokens_size + (size_t)i * max_len;
    for (int j = 0; j < max_len; ++j) {
      row[j] = j < (int)ids.size() ? ids[j] : 0;
      mrow[j] = j < (int)ids.size() ? 1 : 0;
      lrow[j] = (j >= 1 && j <= content) ? 1 : 0;
      trow[j] = j < (int)sizes.size() ? sizes[j] : 0;
    }
    if (truncated) {
      row[max_len - 1] = f->sep_id;
      for (int j = 0; j < max_len; ++j) mrow[j] = 1;
    }
  }
  return 0;
}

}  // extern "C"
