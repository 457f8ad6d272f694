// Cross-process shared-memory ring-buffer queue (the port's copy of
// ``csrc/shm_queue.cc``, with the same C ABI).
//
// Host transport between sampling processes and their consumer: a byte
// ring in POSIX shared memory carrying variable-size serialized messages.
// A single process-shared robust mutex and two condvars guard the framed
// ring (modulo memcpy handles the wrap).  Multi-producer/multi-consumer
// safe.  The one difference from ``csrc/shm_queue.cc``: ``create``
// reserves the segment's pages with ``posix_fallocate``, so a segment that
// does not fit in /dev/shm fails at creation (NULL, errno ENOSPC) instead
// of raising SIGBUS at the first write past the free space.
//
// C ABI (for ctypes): glt_shmq_create / attach / enqueue / dequeue /
// close / unlink.  Built with g++ (host code) by
// ``glt_tpu_torch/channel/native.py``.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// head/tail are MONOTONIC byte offsets (reduced mod capacity only when
// indexing the ring): bytes-in-ring is always tail - head and "queue
// non-empty" is head != tail, so neither needs its own field.  That makes
// each queue operation a SINGLE committing store (tail += ... or
// head += ...), which is what lets robust-mutex recovery after a producer
// dies mid-critical-section be sound: any death before the commit store
// leaves fully consistent state (at worst one fully written but
// unpublished message past tail, which the next enqueue overwrites).
struct Header {
  pthread_mutex_t mu;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
  uint64_t capacity;   // ring bytes
  uint64_t head;       // monotonic read offset
  uint64_t tail;       // monotonic write offset
  uint32_t magic;
};

constexpr uint32_t kMagic = 0x474c5451;  // "GLTQ"

struct Queue {
  Header* hdr;
  uint8_t* ring;
  uint64_t map_size;
  char name[256];
};

void ring_write(Queue* q, uint64_t pos, const void* src, uint64_t len) {
  uint64_t cap = q->hdr->capacity;
  uint64_t off = pos % cap;
  uint64_t first = (off + len <= cap) ? len : cap - off;
  memcpy(q->ring + off, src, first);
  if (first < len) {
    memcpy(q->ring, static_cast<const uint8_t*>(src) + first, len - first);
  }
}

void ring_read(Queue* q, uint64_t pos, void* dst, uint64_t len) {
  uint64_t cap = q->hdr->capacity;
  uint64_t off = pos % cap;
  uint64_t first = (off + len <= cap) ? len : cap - off;
  memcpy(dst, q->ring + off, first);
  if (first < len) {
    memcpy(static_cast<uint8_t*>(dst) + first, q->ring, len - first);
  }
}

// Lock handling robust-mutex owner death: every queue operation publishes
// with a single store to head or tail (see Header comment), so a process
// killed anywhere inside the critical section leaves consistent state —
// mark the mutex consistent and continue.
int q_lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

// Absolute-deadline wait (deadline computed ONCE by the caller, so a
// consumer repeatedly woken and beaten to the message by another consumer
// still times out on schedule).  deadline == nullptr waits forever.
int q_deadline_wait(pthread_cond_t* cv, Header* h,
                    const struct timespec* deadline) {
  int rc = deadline ? pthread_cond_timedwait(cv, &h->mu, deadline)
                    : pthread_cond_wait(cv, &h->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

struct timespec deadline_in_ms(int timeout_ms) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return ts;
}

}  // namespace

extern "C" {

// Create (O_CREAT|O_EXCL semantics are not enforced: re-creating an
// existing name reinitializes it).  Returns NULL on failure.
void* glt_shmq_create(const char* name, uint64_t capacity) {
  int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t map_size = sizeof(Header) + capacity;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    return nullptr;
  }
  int rc = posix_fallocate(fd, 0, static_cast<off_t>(map_size));
  if (rc != 0) {
    close(fd);
    shm_unlink(name);
    errno = rc;
    return nullptr;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Queue* q = new Queue();
  q->hdr = static_cast<Header*>(mem);
  q->ring = static_cast<uint8_t*>(mem) + sizeof(Header);
  q->map_size = map_size;
  snprintf(q->name, sizeof(q->name), "%s", name);

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // Robust: a sampling worker killed while holding the lock must not wedge
  // the trainer (the reference's SysV semaphores have the same failure
  // mode and no recovery).
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&q->hdr->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(&q->hdr->not_full, &ca);
  pthread_cond_init(&q->hdr->not_empty, &ca);
  q->hdr->capacity = capacity;
  q->hdr->head = q->hdr->tail = 0;
  q->hdr->magic = kMagic;
  return q;
}

// Attach to an existing queue by name (the reference's pickle-by-shmid
// re-attach, py_export.cc:125-140). Returns NULL on failure.
void* glt_shmq_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Queue* q = new Queue();
  q->hdr = static_cast<Header*>(mem);
  q->ring = static_cast<uint8_t*>(mem) + sizeof(Header);
  q->map_size = static_cast<uint64_t>(st.st_size);
  snprintf(q->name, sizeof(q->name), "%s", name);
  if (q->hdr->magic != kMagic) {
    munmap(mem, q->map_size);
    delete q;
    return nullptr;
  }
  return q;
}

// Blocking enqueue of one message. Returns 0 on success, -1 if the
// message can never fit (size + frame > capacity).
int glt_shmq_enqueue(void* qp, const void* data, uint64_t size) {
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->hdr;
  uint64_t need = size + sizeof(uint64_t);
  if (need > h->capacity) return -1;
  q_lock(h);
  while (h->capacity - (h->tail - h->head) < need) {
    q_deadline_wait(&h->not_full, h, nullptr);
  }
  ring_write(q, h->tail, &size, sizeof(uint64_t));
  ring_write(q, h->tail + sizeof(uint64_t), data, size);
  h->tail += need;  // single commit store
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Peek next message size (blocking until a message exists).
uint64_t glt_shmq_next_size(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->hdr;
  q_lock(h);
  while (h->head == h->tail) {
    q_deadline_wait(&h->not_empty, h, nullptr);
  }
  uint64_t size;
  ring_read(q, h->head, &size, sizeof(uint64_t));
  pthread_mutex_unlock(&h->mu);
  return size;
}

// Blocking dequeue. Returns message size, or -1 if out_cap is too small
// (message stays queued).
int64_t glt_shmq_dequeue(void* qp, void* out, uint64_t out_cap) {
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->hdr;
  q_lock(h);
  while (h->head == h->tail) {
    q_deadline_wait(&h->not_empty, h, nullptr);
  }
  uint64_t size;
  ring_read(q, h->head, &size, sizeof(uint64_t));
  if (size > out_cap) {
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  ring_read(q, h->head + sizeof(uint64_t), out, size);
  h->head += size + sizeof(uint64_t);  // single commit store
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(size);
}

uint64_t glt_shmq_msg_count(void* qp) {
  // Message count is derived by walking the frame headers between head and
  // tail (queues hold few MB-scale messages, so the walk is trivial); it
  // is no longer authoritative state that could be torn by owner death.
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->hdr;
  q_lock(h);
  uint64_t n = 0;
  for (uint64_t pos = h->head; pos != h->tail;) {
    uint64_t size;
    ring_read(q, pos, &size, sizeof(uint64_t));
    pos += size + sizeof(uint64_t);
    ++n;
  }
  pthread_mutex_unlock(&h->mu);
  return n;
}

// Atomic size+payload dequeue with optional timeout: allocates the exact
// message size under the lock, so concurrent consumers can never race a
// next_size/dequeue pair (the reference's SampleQueue has the same
// single-critical-section contract).  timeout_ms < 0 blocks forever;
// returns 0 on success (*out malloc'd, caller frees via glt_shmq_buf_free),
// 1 on timeout, -1 on error.
int glt_shmq_dequeue_alloc(void* qp, uint8_t** out, uint64_t* out_size,
                           int timeout_ms) {
  Queue* q = static_cast<Queue*>(qp);
  Header* h = q->hdr;
  // Deadline fixed BEFORE the wait loop: a consumer woken by an enqueue
  // but beaten to the message by another consumer must not restart its
  // full timeout, or steady message traffic starves the timeout forever.
  struct timespec deadline;
  bool has_deadline = timeout_ms >= 0;
  if (has_deadline) deadline = deadline_in_ms(timeout_ms);
  q_lock(h);
  while (h->head == h->tail) {
    int rc = q_deadline_wait(&h->not_empty, h,
                             has_deadline ? &deadline : nullptr);
    if (rc == ETIMEDOUT) {
      // POSIX allows a wakeup to race the deadline: recheck the predicate
      // so an already-available message is never reported as a timeout.
      if (h->head != h->tail) break;
      pthread_mutex_unlock(&h->mu);
      return 1;
    }
    if (rc != 0) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  uint64_t size;
  ring_read(q, h->head, &size, sizeof(uint64_t));
  uint8_t* buf = static_cast<uint8_t*>(malloc(size ? size : 1));
  if (buf == nullptr) {
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  ring_read(q, h->head + sizeof(uint64_t), buf, size);
  h->head += size + sizeof(uint64_t);  // single commit store
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  *out = buf;
  *out_size = size;
  return 0;
}

void glt_shmq_buf_free(uint8_t* buf) { free(buf); }

void glt_shmq_close(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  munmap(q->hdr, q->map_size);
  delete q;
}

int glt_shmq_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
