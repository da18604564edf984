// Native chunk-slot allocator for the TSDF volume host runtime.
//
// Replaces the role of open_chisel's ChunkMap spatial hash
// (ref: Structure/ChunkManager.h:44-119 ChunkHasher + ChunkMap) for the
// slot-indexed TPU design: the device holds dense [capacity, 512] arrays;
// this maps integer chunk IDs -> slot with a free list, and deduplicates
// the per-frame candidate-ID stream (the host-side hot path: ~1.5M IDs
// per VGA frame at stride 1).
//
// Exposed via extern "C" for ctypes. Single-threaded per volume (the
// pipeline touches the allocator from one host thread, like the
// reference's map thread).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// pack chunk coords (each in ±(2^20)) into a 64-bit key
static inline uint64_t pack_key(int32_t x, int32_t y, int32_t z) {
  const uint64_t m = (1u << 21) - 1;
  return ((uint64_t)((uint32_t)x & m)) | ((uint64_t)((uint32_t)y & m) << 21) |
         ((uint64_t)((uint32_t)z & m) << 42);
}

static inline uint64_t hash_key(uint64_t k) {
  // splitmix64 finalizer
  k ^= k >> 30;
  k *= 0xbf58476d1ce4e5b9ULL;
  k ^= k >> 27;
  k *= 0x94d049bb133111ebULL;
  k ^= k >> 31;
  return k;
}

struct Alloc {
  int64_t capacity;
  int64_t table_size;   // power of two
  std::vector<uint64_t> keys;     // table_size, EMPTY sentinel
  std::vector<int64_t> vals;      // table_size -> slot
  std::vector<int64_t> free_list; // available slots (LIFO)
  std::vector<int32_t> ids;       // capacity*3 chunk coords per slot
  std::vector<uint8_t> used;      // capacity
  std::vector<uint64_t> stamp;    // capacity visited generation
  uint64_t generation = 0;
  int64_t n_used = 0;

  static constexpr uint64_t EMPTY = ~0ULL;

  explicit Alloc(int64_t cap) : capacity(cap) {
    table_size = 1;
    while (table_size < cap * 4) table_size <<= 1;
    keys.assign(table_size, EMPTY);
    vals.assign(table_size, -1);
    ids.assign(cap * 3, 0);
    used.assign(cap, 0);
    stamp.assign(cap, 0);
    free_list.reserve(cap);
    for (int64_t i = cap - 1; i >= 0; --i) free_list.push_back(i);
  }

  int64_t find_or_insert(int32_t x, int32_t y, int32_t z, bool allocate,
                         bool* inserted) {
    *inserted = false;
    uint64_t key = pack_key(x, y, z);
    uint64_t mask = (uint64_t)table_size - 1;
    uint64_t pos = hash_key(key) & mask;
    while (true) {
      if (keys[pos] == key) return vals[pos];
      if (keys[pos] == EMPTY) {
        if (!allocate) return -1;
        if (free_list.empty()) return -1;
        int64_t slot = free_list.back();
        free_list.pop_back();
        keys[pos] = key;
        vals[pos] = slot;
        ids[slot * 3 + 0] = x;
        ids[slot * 3 + 1] = y;
        ids[slot * 3 + 2] = z;
        used[slot] = 1;
        ++n_used;
        *inserted = true;
        return slot;
      }
      pos = (pos + 1) & mask;
    }
  }

  void erase(int64_t slot) {
    if (slot < 0 || slot >= capacity || !used[slot]) return;
    uint64_t key = pack_key(ids[slot * 3], ids[slot * 3 + 1], ids[slot * 3 + 2]);
    uint64_t mask = (uint64_t)table_size - 1;
    uint64_t pos = hash_key(key) & mask;
    while (keys[pos] != key) {
      if (keys[pos] == EMPTY) return;
      pos = (pos + 1) & mask;
    }
    // backward-shift deletion keeps probe chains intact
    uint64_t hole = pos;
    uint64_t next = (pos + 1) & mask;
    while (keys[next] != EMPTY) {
      uint64_t ideal = hash_key(keys[next]) & mask;
      bool movable = ((next - ideal) & mask) >= ((next - hole) & mask);
      if (movable) {
        keys[hole] = keys[next];
        vals[hole] = vals[next];
        hole = next;
      }
      next = (next + 1) & mask;
    }
    keys[hole] = EMPTY;
    vals[hole] = -1;
    used[slot] = 0;
    --n_used;
    free_list.push_back(slot);
  }
};

}  // namespace

extern "C" {

void* ca_create(int64_t capacity) { return new Alloc(capacity); }

void ca_destroy(void* h) { delete (Alloc*)h; }

int64_t ca_count(void* h) { return ((Alloc*)h)->n_used; }

// Deduplicate `n` chunk IDs (rows of 3 int32) and look up / allocate
// slots. Writes unique slots to out_slots (size >= capacity), newly
// allocated slots to out_new. Returns number of unique touched slots;
// *n_new gets the count of fresh allocations. IDs that cannot be
// allocated (pool exhausted / allocate=0 and absent) are skipped.
int64_t ca_touch(void* h, const int32_t* ids, int64_t n, int32_t allocate,
                 int64_t* out_slots, int64_t* out_new, int64_t* n_new) {
  Alloc* a = (Alloc*)h;
  a->generation++;
  int64_t n_out = 0, n_fresh = 0;
  for (int64_t i = 0; i < n; ++i) {
    bool inserted = false;
    int64_t slot = a->find_or_insert(ids[i * 3], ids[i * 3 + 1], ids[i * 3 + 2],
                                     allocate != 0, &inserted);
    if (slot < 0) continue;
    if (a->stamp[slot] != a->generation) {
      a->stamp[slot] = a->generation;
      out_slots[n_out++] = slot;
      if (inserted) out_new[n_fresh++] = slot;
    }
  }
  *n_new = n_fresh;
  return n_out;
}

// Plain lookup of n ids -> slots (-1 when absent), no dedup.
void ca_lookup(void* h, const int32_t* ids, int64_t n, int64_t* out_slots) {
  Alloc* a = (Alloc*)h;
  for (int64_t i = 0; i < n; ++i) {
    bool ins;
    out_slots[i] =
        a->find_or_insert(ids[i * 3], ids[i * 3 + 1], ids[i * 3 + 2], false, &ins);
  }
}

void ca_release(void* h, const int64_t* slots, int64_t n) {
  Alloc* a = (Alloc*)h;
  for (int64_t i = 0; i < n; ++i) a->erase(slots[i]);
}

// Copy slot -> chunk-ID table (capacity*3 int32) and used flags.
void ca_export(void* h, int32_t* ids_out, uint8_t* used_out) {
  Alloc* a = (Alloc*)h;
  std::memcpy(ids_out, a->ids.data(), a->capacity * 3 * sizeof(int32_t));
  std::memcpy(used_out, a->used.data(), a->capacity * sizeof(uint8_t));
}

// Bulk import (checkpoint restore): register `n` (slot, id) pairs.
void ca_import(void* h, const int64_t* slots, const int32_t* ids, int64_t n) {
  Alloc* a = (Alloc*)h;
  // rebuild free list excluding imported slots
  std::vector<uint8_t> taken(a->capacity, 0);
  for (int64_t i = 0; i < n; ++i) taken[slots[i]] = 1;
  a->free_list.clear();
  for (int64_t s = a->capacity - 1; s >= 0; --s)
    if (!taken[s]) a->free_list.push_back(s);
  for (int64_t i = 0; i < n; ++i) {
    int64_t slot = slots[i];
    uint64_t key = pack_key(ids[i * 3], ids[i * 3 + 1], ids[i * 3 + 2]);
    uint64_t mask = (uint64_t)a->table_size - 1;
    uint64_t pos = hash_key(key) & mask;
    while (a->keys[pos] != Alloc::EMPTY) pos = (pos + 1) & mask;
    a->keys[pos] = key;
    a->vals[pos] = slot;
    a->ids[slot * 3] = ids[i * 3];
    a->ids[slot * 3 + 1] = ids[i * 3 + 1];
    a->ids[slot * 3 + 2] = ids[i * 3 + 2];
    a->used[slot] = 1;
  }
  a->n_used = n;
}

}  // extern "C"
