// Native shared-memory batch queue for the port's DataLoader (a copy of
// `paddle_tpu/io/native/shm_queue.cpp`: the same segment layout and C ABI,
// so a queue created by either package's library opens in the other's).
//
// Counterpart of the reference's native data-pipeline core: the C++ blocking
// queues + shared-memory tensor transport behind multi-process DataLoader
// workers (`paddle/fluid/imperative/data_loader.cc`, `fluid/dataloader/
// dataloader_iter.py:375` shared-memory path, and the `data_feed.cc` reader
// machinery). Worker processes serialize batches straight into a POSIX
// shared-memory ring; the trainer process maps the same ring and hands
// zero-extra-copy views to numpy — no pickling through pipes.
//
// Layout of the shm segment:
//   [Ctrl][slot_0 hdr|data][slot_1 hdr|data]...[slot_{n-1}]
// slot hdr = [len:u64][state:u64]. Ctrl holds a process-shared mutex +
// condvars and the ring indices. Payload memcpys happen OUTSIDE the mutex
// (claim/commit protocol): a producer claims the tail slot under the lock,
// copies lock-free, then commits READY; the single consumer claims the head
// slot, copies lock-free, then releases it EMPTY. With multi-MB batches this
// is what keeps N workers' copies parallel instead of serialized on the ring
// mutex. Single consumer, multiple producers.
//
// Built on demand with `g++ -O2 -shared -fPIC` (no pybind11 — plain C ABI via
// ctypes, per the environment's binding guidance).

#include <cerrno>
#include <csignal>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Ctrl {
  pthread_mutex_t mu;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
  uint64_t head;       // next slot to pop
  uint64_t tail;       // next slot to push
  uint64_t claimed;    // slots claimed by producers (writing or ready)
  uint64_t slots;
  uint64_t slot_size;  // payload bytes per slot
  uint32_t closed;
  uint32_t magic;
};

enum SlotState : uint64_t { kEmpty = 0, kWriting = 1, kReady = 2 };

struct SlotHdr {
  uint64_t len;
  uint64_t state;
  uint64_t producer_pid;  // for dead-producer reclamation (kWriting orphan)
};

constexpr uint32_t kMagic = 0x53484d52;  // "SHMR" (v2: claim/commit slots)

struct Handle {
  Ctrl* ctrl;
  uint8_t* base;    // start of slot area
  size_t map_len;
  int owner;
  char name[256];
};

inline SlotHdr* slot_hdr(Handle* h, uint64_t idx) {
  return (SlotHdr*)(h->base + idx * (sizeof(SlotHdr) + h->ctrl->slot_size));
}

inline uint8_t* slot_data(Handle* h, uint64_t idx) {
  return (uint8_t*)slot_hdr(h, idx) + sizeof(SlotHdr);
}

// robust-aware lock: if the previous owner died while HOLDING the mutex,
// mark the state consistent. Death between claim and commit (no lock held)
// is handled separately by dead-producer reclamation in shmq_pop_timed.
inline int robust_lock(Ctrl* c) {
  int rc = pthread_mutex_lock(&c->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&c->mu);
    rc = 0;
  }
  return rc;
}

// cond waits re-acquire the mutex internally, so EOWNERDEAD can surface from
// them too (the common case: peer dies while we sleep on the condvar); the
// mutex must be marked consistent there as well or it becomes permanently
// ENOTRECOVERABLE
inline int robust_cond_wait(pthread_cond_t* cv, Ctrl* c) {
  int rc = pthread_cond_wait(cv, &c->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&c->mu);
    rc = 0;
  }
  return rc;
}

inline int robust_cond_timedwait(pthread_cond_t* cv, Ctrl* c,
                                 const struct timespec* ts) {
  int rc = pthread_cond_timedwait(cv, &c->mu, ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&c->mu);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

void* shmq_create(const char* name, uint64_t slots, uint64_t slot_size) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(Ctrl) + slots * (sizeof(SlotHdr) + slot_size);
  if (ftruncate(fd, (off_t)len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Ctrl* c = (Ctrl*)mem;
  memset(c, 0, sizeof(Ctrl));
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // robust: a worker SIGKILLed/OOM-killed while holding the mutex must not
  // deadlock the trainer — the next locker gets EOWNERDEAD and recovers;
  // death during the lock-free copy window is reclaimed via producer_pid
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&c->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&c->not_full, &ca);
  pthread_cond_init(&c->not_empty, &ca);
  c->slots = slots;
  c->slot_size = slot_size;
  c->magic = kMagic;
  Handle* h = new Handle();
  h->ctrl = c;
  h->base = (uint8_t*)mem + sizeof(Ctrl);
  h->map_len = len;
  h->owner = 1;
  strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

void* shmq_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Ctrl* c = (Ctrl*)mem;
  if (c->magic != kMagic) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  Handle* h = new Handle();
  h->ctrl = c;
  h->base = (uint8_t*)mem + sizeof(Ctrl);
  h->map_len = (size_t)st.st_size;
  h->owner = 0;
  strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

// blocking push; returns 0 ok, -1 closed, -2 payload too large
int shmq_push(void* hv, const void* data, uint64_t len) {
  Handle* h = (Handle*)hv;
  Ctrl* c = h->ctrl;
  if (len > c->slot_size) return -2;
  robust_lock(c);
  while (c->claimed == c->slots && !c->closed)
    robust_cond_wait(&c->not_full, c);
  if (c->closed) {
    pthread_mutex_unlock(&c->mu);
    return -1;
  }
  uint64_t my = c->tail;
  c->tail = (c->tail + 1) % c->slots;
  c->claimed++;
  SlotHdr* hdr = slot_hdr(h, my);
  hdr->state = kWriting;
  hdr->producer_pid = (uint64_t)getpid();
  pthread_mutex_unlock(&c->mu);

  // bulk copy outside the lock — concurrent producers copy in parallel
  hdr->len = len;
  memcpy(slot_data(h, my), data, len);

  robust_lock(c);
  hdr->state = kReady;
  pthread_cond_broadcast(&c->not_empty);
  pthread_mutex_unlock(&c->mu);
  return 0;
}

// blocking pop into caller buffer; returns payload length, -1 closed+empty,
// -2 caller buffer too small (queue state unchanged), -3 timed out.
// timeout_ms < 0 waits forever. Python polls with short timeouts so
// KeyboardInterrupt and DataLoader(timeout=...) both work.
int64_t shmq_pop_timed(void* hv, void* out, uint64_t cap, int64_t timeout_ms) {
  if (timeout_ms < 0) {
    // infinite wait = loop over short timed waits so dead-producer
    // reclamation (below) runs on this path too; -3 never escapes
    for (;;) {
      int64_t r = shmq_pop_timed(hv, out, cap, 200);
      if (r != -3) return r;
    }
  }
  Handle* h = (Handle*)hv;
  Ctrl* c = h->ctrl;
  robust_lock(c);
  // single consumer: the head slot is ours once its producer commits READY
  {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) {
      ts.tv_sec += 1;
      ts.tv_nsec -= 1000000000L;
    }
    while (slot_hdr(h, c->head)->state != kReady && !c->closed) {
      if (robust_cond_timedwait(&c->not_empty, c, &ts) == ETIMEDOUT) {
        // a producer that died between claim and commit (no lock held, so
        // EOWNERDEAD cannot fire) leaves the head slot kWriting forever:
        // reclaim it — one lost in-flight batch, matching the pre-v2
        // recovery semantics
        SlotHdr* head_hdr = slot_hdr(h, c->head);
        if (head_hdr->state == kWriting && head_hdr->producer_pid != 0 &&
            kill((pid_t)head_hdr->producer_pid, 0) != 0 && errno == ESRCH) {
          head_hdr->state = kEmpty;
          c->head = (c->head + 1) % c->slots;
          c->claimed--;
          pthread_cond_signal(&c->not_full);
          continue;
        }
        if (slot_hdr(h, c->head)->state != kReady) {
          int closed = c->closed;
          pthread_mutex_unlock(&c->mu);
          return closed ? -1 : -3;
        }
        break;
      }
    }
  }
  if (slot_hdr(h, c->head)->state != kReady && c->closed) {
    pthread_mutex_unlock(&c->mu);
    return -1;
  }
  uint64_t my = c->head;
  SlotHdr* hdr = slot_hdr(h, my);
  uint64_t len = hdr->len;
  if (len > cap) {
    pthread_mutex_unlock(&c->mu);
    return -2;
  }
  pthread_mutex_unlock(&c->mu);

  // bulk copy outside the lock; the slot cannot be reclaimed until we
  // release it below (producers gate on `claimed`)
  memcpy(out, slot_data(h, my), len);

  robust_lock(c);
  hdr->state = kEmpty;
  c->head = (my + 1) % c->slots;
  c->claimed--;
  pthread_cond_signal(&c->not_full);
  pthread_mutex_unlock(&c->mu);
  return (int64_t)len;
}

int64_t shmq_pop(void* hv, void* out, uint64_t cap) {
  return shmq_pop_timed(hv, out, cap, -1);
}

uint64_t shmq_slot_size(void* hv) { return ((Handle*)hv)->ctrl->slot_size; }

uint64_t shmq_count(void* hv) {
  Handle* h = (Handle*)hv;
  robust_lock(h->ctrl);
  uint64_t n = h->ctrl->claimed;
  pthread_mutex_unlock(&h->ctrl->mu);
  return n;
}

void shmq_close(void* hv) {
  Handle* h = (Handle*)hv;
  Ctrl* c = h->ctrl;
  robust_lock(c);
  c->closed = 1;
  pthread_cond_broadcast(&c->not_empty);
  pthread_cond_broadcast(&c->not_full);
  pthread_mutex_unlock(&c->mu);
}

void shmq_release(void* hv) {
  Handle* h = (Handle*)hv;
  int owner = h->owner;
  char name[256];
  strncpy(name, h->name, sizeof(name));
  munmap((void*)h->ctrl, h->map_len);
  if (owner) shm_unlink(name);
  delete h;
}

}  // extern "C"
