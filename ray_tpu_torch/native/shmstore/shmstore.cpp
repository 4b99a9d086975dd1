// Shared-memory object pool: the C++ core of the per-node object store.
//
// TPU-native equivalent of the reference's plasma store (reference:
// src/ray/object_manager/plasma/store.h:55, plasma_allocator.h + dlmalloc,
// eviction_policy.h LRU, obj_lifecycle_mgr.h). Design difference: plasma
// is a daemon brokering mmap fds over a unix socket; here the pool is one
// mmap'd file in /dev/shm that every process on the node maps directly,
// with a process-shared mutex guarding a fixed open-addressing object
// table and a first-fit free-list heap. create/seal/get/release/delete
// plus LRU eviction of sealed, unreferenced objects when an allocation
// does not fit. No daemon, no fd-passing (fling.cc) needed: POSIX shm on
// Linux is just files.
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cerrno>
#include <cstdio>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055504F4F4CULL;  // "RTPUPOOL"
constexpr uint32_t kIdLen = 20;                     // ObjectID bytes
constexpr uint64_t kAlign = 64;

inline uint64_t aligned(uint64_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

struct Slot {
  uint8_t id[kIdLen];
  // 0 empty, 1 creating, 2 sealed, 3 tombstone,
  // 4 zombie: deleted-but-pinned — unlinked from lookups (get/contains
  // miss, the id is reusable) but the heap block stays allocated until
  // the last reader releases (plasma semantics: delete defers the free,
  // never invalidates memory a client still maps).
  uint8_t state;
  uint8_t pad[3];
  uint32_t refcount;
  uint64_t offset;  // heap offset of payload
  uint64_t size;
  uint64_t lru;  // last-touch tick
};

// Free-list node, stored inside the heap itself. While a block is
// ALLOCATED, `next` holds the owning slot's index instead (so a release
// keyed by payload offset finds its slot in O(1) — see shm_release_at).
struct Block {
  uint64_t size;   // payload bytes of this block (excluding header)
  uint64_t next;   // free: heap offset of next free block (0 = end)
};

struct Header {
  uint64_t magic;
  uint64_t capacity;      // total file size
  uint64_t heap_off;      // start of heap region
  uint64_t heap_size;
  uint64_t free_head;     // heap offset of first free block, 0 = none
  uint64_t lru_clock;
  uint64_t used_bytes;
  uint32_t num_slots;
  uint32_t pad;
  pthread_mutex_t mutex;  // PTHREAD_PROCESS_SHARED
  // Slot table follows, then heap.
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t size;
  Header* hdr;
  Slot* slots;
};

inline Block* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<Block*>(h->base + h->hdr->heap_off + off);
}

uint64_t hash_id(const uint8_t* id) {
  uint64_t x = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) { x ^= id[i]; x *= 1099511628211ULL; }
  return x;
}

Slot* find_slot(Handle* h, const uint8_t* id, bool for_insert) {
  Header* hdr = h->hdr;
  uint64_t n = hdr->num_slots;
  uint64_t i = hash_id(id) % n;
  Slot* first_tomb = nullptr;
  for (uint64_t probes = 0; probes < n; probes++, i = (i + 1) % n) {
    Slot* s = &h->slots[i];
    if (s->state == 0) return for_insert ? (first_tomb ? first_tomb : s) : nullptr;
    if (s->state == 3) { if (for_insert && !first_tomb) first_tomb = s; continue; }
    if (s->state == 4) continue;  // zombie: unlinked, slot still occupied
    if (memcmp(s->id, id, kIdLen) == 0) return s;
  }
  return first_tomb;  // table full of tombstones/entries
}

// Heap: singly-linked first-fit free list. Offsets are relative to
// heap_off; a block's payload starts at off + sizeof(Block).
uint64_t heap_alloc(Handle* h, uint64_t want) {
  want = aligned(want);
  Header* hdr = h->hdr;
  uint64_t prev = 0;
  uint64_t cur = hdr->free_head;
  while (cur) {
    Block* b = block_at(h, cur);
    if (b->size >= want) {
      uint64_t remain = b->size - want;
      if (remain > sizeof(Block) + kAlign) {
        // split: tail of this block becomes a new free block
        uint64_t tail_off = cur + sizeof(Block) + want;
        Block* tail = block_at(h, tail_off);
        tail->size = remain - sizeof(Block);
        tail->next = b->next;
        b->size = want;
        if (prev) block_at(h, prev)->next = tail_off; else hdr->free_head = tail_off;
      } else {
        if (prev) block_at(h, prev)->next = b->next; else hdr->free_head = b->next;
      }
      hdr->used_bytes += b->size + sizeof(Block);
      return cur + sizeof(Block);  // payload offset
    }
    prev = cur;
    cur = b->next;
  }
  return UINT64_MAX;
}

void heap_free(Handle* h, uint64_t payload_off) {
  Header* hdr = h->hdr;
  uint64_t off = payload_off - sizeof(Block);
  Block* b = block_at(h, off);
  hdr->used_bytes -= b->size + sizeof(Block);
  // insert sorted by offset, coalesce neighbors
  uint64_t prev = 0, cur = hdr->free_head;
  while (cur && cur < off) { prev = cur; cur = block_at(h, cur)->next; }
  b->next = cur;
  if (prev) block_at(h, prev)->next = off; else hdr->free_head = off;
  // coalesce with next
  if (cur && off + sizeof(Block) + b->size == cur) {
    Block* nb = block_at(h, cur);
    b->size += sizeof(Block) + nb->size;
    b->next = nb->next;
  }
  // coalesce with prev
  if (prev) {
    Block* pb = block_at(h, prev);
    if (prev + sizeof(Block) + pb->size == off) {
      pb->size += sizeof(Block) + b->size;
      pb->next = b->next;
    }
  }
}

// Evict the least-recently-used sealed object with refcount 0.
// Returns true if something was evicted.
bool evict_one(Handle* h) {
  Header* hdr = h->hdr;
  Slot* victim = nullptr;
  for (uint32_t i = 0; i < hdr->num_slots; i++) {
    Slot* s = &h->slots[i];
    if (s->state == 2 && s->refcount == 0) {
      if (!victim || s->lru < victim->lru) victim = s;
    }
  }
  if (!victim) return false;
  heap_free(h, victim->offset);
  victim->state = 3;  // tombstone
  return true;
}

class MutexGuard {
 public:
  explicit MutexGuard(pthread_mutex_t* m) : m_(m) {
    int rc = pthread_mutex_lock(m_);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(m_);
  }
  ~MutexGuard() { pthread_mutex_unlock(m_); }
 private:
  pthread_mutex_t* m_;
};

}  // namespace

extern "C" {

// Create the pool file (head/daemon side). Returns 0 on success.
int shm_pool_create(const char* path, uint64_t capacity, uint32_t num_slots) {
  uint64_t slots_off = aligned(sizeof(Header));
  uint64_t heap_off = aligned(slots_off + num_slots * sizeof(Slot));
  if (capacity < heap_off + kAlign * 16) return -EINVAL;
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return -errno;
  if (ftruncate(fd, (off_t)capacity) != 0) { int e = errno; close(fd); unlink(path); return -e; }
  void* mem = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { int e = errno; close(fd); unlink(path); return -e; }
  Header* hdr = static_cast<Header*>(mem);
  memset(hdr, 0, heap_off);
  hdr->capacity = capacity;
  hdr->heap_off = heap_off;
  hdr->heap_size = capacity - heap_off;
  hdr->num_slots = num_slots;
  hdr->lru_clock = 1;
  hdr->used_bytes = 0;
  // one big free block at offset kAlign (0 is reserved: "no block")
  Block* first = reinterpret_cast<Block*>(static_cast<uint8_t*>(mem) + heap_off + kAlign);
  first->size = hdr->heap_size - kAlign - sizeof(Block);
  first->next = 0;
  hdr->free_head = kAlign;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &attr);
  hdr->magic = kMagic;
  msync(mem, heap_off, MS_SYNC);
  munmap(mem, capacity);
  close(fd);
  return 0;
}

// Open an existing pool. Returns an opaque handle pointer, or null.
void* shm_pool_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  Header* hdr = static_cast<Header*>(mem);
  if (hdr->magic != kMagic) { munmap(mem, st.st_size); close(fd); return nullptr; }
  Handle* h = new Handle;
  h->fd = fd;
  h->base = static_cast<uint8_t*>(mem);
  h->size = st.st_size;
  h->hdr = hdr;
  h->slots = reinterpret_cast<Slot*>(h->base + aligned(sizeof(Header)));
  return h;
}

void shm_pool_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->base, h->size);
  close(h->fd);
  delete h;
}

// Base pointer of the mapping (so Python can mmap-slice payloads itself).
uint8_t* shm_pool_base(void* handle) { return static_cast<Handle*>(handle)->base; }
uint64_t shm_pool_capacity(void* handle) { return static_cast<Handle*>(handle)->hdr->capacity; }
uint64_t shm_pool_used(void* handle) { return static_cast<Handle*>(handle)->hdr->used_bytes; }

// Create an object of `size` bytes. On success returns 0 and writes the
// absolute byte offset of the payload into *out_off. -EEXIST if the id
// already exists, -ENOMEM if it cannot fit even after eviction.
int shm_create(void* handle, const uint8_t* id, uint64_t size, uint64_t* out_off) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, /*for_insert=*/false);
  if (s && (s->state == 1 || s->state == 2)) return -EEXIST;
  uint64_t payload;
  while ((payload = heap_alloc(h, size ? size : 1)) == UINT64_MAX) {
    if (!evict_one(h)) return -ENOMEM;
  }
  s = find_slot(h, id, /*for_insert=*/true);
  if (!s) { heap_free(h, payload); return -ENOSPC; }
  memcpy(s->id, id, kIdLen);
  s->state = 1;
  s->refcount = 1;  // creator holds a ref until seal+release
  s->offset = payload;
  s->size = size;
  s->lru = ++h->hdr->lru_clock;
  // Bind block → slot for offset-keyed release.
  block_at(h, payload - sizeof(Block))->next = (uint64_t)(s - h->slots);
  *out_off = h->hdr->heap_off + payload;
  return 0;
}

int shm_seal(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state != 1) return -ENOENT;
  s->state = 2;
  s->refcount = 0;
  s->lru = ++h->hdr->lru_clock;
  return 0;
}

// Pin + locate a sealed object. Returns 0 and fills offset/size.
int shm_get(void* handle, const uint8_t* id, uint64_t* out_off, uint64_t* out_size) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state != 2) return -ENOENT;
  s->refcount++;
  s->lru = ++h->hdr->lru_clock;
  *out_off = h->hdr->heap_off + s->offset;
  *out_size = s->size;
  return 0;
}

int shm_contains(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, false);
  return (s && s->state == 2) ? 1 : 0;
}

int shm_release(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state != 2) return -ENOENT;
  if (s->refcount > 0) s->refcount--;
  return 0;
}

int shm_delete(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state == 0 || s->state == 3) return -ENOENT;
  if (s->refcount > 0) {
    // Pinned (sealed readers, or a creator mid-memcpy on state 1):
    // unlink the id now (subsequent get/contains miss, the id may be
    // re-created) and free the block when the last holder releases —
    // never free memory another process is still writing or reading.
    s->state = 4;
    return 0;
  }
  heap_free(h, s->offset);
  s->state = 3;
  return 0;
}

// Release keyed by the payload's ABSOLUTE offset (what shm_get returned).
// Unlike release-by-id this stays correct when the id was deleted and
// re-created while this reader still pinned the OLD allocation: the
// offset identifies the allocation, and the block header carries its
// owning slot index.
int shm_release_at(void* handle, uint64_t abs_off) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Header* hdr = h->hdr;
  if (abs_off < hdr->heap_off + sizeof(Block)) return -EINVAL;
  uint64_t payload = abs_off - hdr->heap_off;
  Block* b = block_at(h, payload - sizeof(Block));
  uint64_t idx = b->next;
  if (idx >= hdr->num_slots) return -ENOENT;
  Slot* s = &h->slots[idx];
  if (s->offset != payload || (s->state != 2 && s->state != 4)) return -ENOENT;
  if (s->refcount > 0) s->refcount--;
  if (s->state == 4 && s->refcount == 0) {
    heap_free(h, s->offset);
    s->state = 3;
  }
  return 0;
}

// Scan sealed, unpinned objects (spill candidates). Fills up to
// `max_entries` of (id, size, lru) triples; returns the count. The spill
// loop ranks by lru ascending and moves cold objects to disk before the
// allocator's LRU eviction would drop them.
int shm_pool_scan(void* handle, uint8_t* out_ids, uint64_t* out_sizes,
                  uint64_t* out_lru, uint32_t max_entries) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  uint32_t n = 0;
  for (uint32_t i = 0; i < h->hdr->num_slots && n < max_entries; i++) {
    Slot* s = &h->slots[i];
    if (s->state == 2 && s->refcount == 0) {
      memcpy(out_ids + (uint64_t)n * kIdLen, s->id, kIdLen);
      out_sizes[n] = s->size;
      out_lru[n] = s->lru;
      n++;
    }
  }
  return (int)n;
}

// Abort an in-progress create (creator died or serialization failed).
int shm_abort(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  MutexGuard g(&h->hdr->mutex);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state != 1) return -ENOENT;
  heap_free(h, s->offset);
  s->state = 3;
  return 0;
}

}  // extern "C"
