// In-order bounded ring buffer for DataLoader prefetch.
//
// Reference analogue: paddle/fluid/operators/reader/buffered_reader.cc
// (the C++ double-buffered reader feeding GPU streams); a copy of
// paddle_tpu/io/native/ringbuf.cpp.  Producers (Python worker threads fetching+collating batches)
// copy packed batches into sequence-addressed slots; the single consumer
// pops strictly in order, so batch order is deterministic regardless of
// worker scheduling — ordering lives HERE, not in a Python reorder dict.
//
// pthread mutex + condvars; slots are malloc'd on demand and reused
// (grow-only), so steady-state has zero allocations.  Buffers are
// contiguous and 64-byte aligned — torch.from_numpy wraps them without
// another gather, and a pinned copy to the card reads them in one pass.
//
// Built at first use by paddle_tpu_torch/io/native/__init__.py
// (g++ -O3 -shared, into build/paddle_tpu_torch/native/).

#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <pthread.h>

namespace {

struct Slot {
    char*   data = nullptr;
    int64_t cap = 0;       // allocated bytes
    int64_t size = 0;      // payload bytes
    bool    full = false;
};

struct Ring {
    Slot*          slots;
    int64_t        capacity;
    int64_t        head;       // next seq to pop
    bool           closed;
    pthread_mutex_t mu;
    pthread_cond_t  can_push;  // a slot freed or closed
    pthread_cond_t  can_pop;   // head slot filled or closed
};

char* ensure_cap(Slot* s, int64_t n) {
    if (s->cap < n) {
        free(s->data);
        int64_t cap = 64;
        while (cap < n) cap <<= 1;
        void* p = nullptr;
        if (posix_memalign(&p, 64, (size_t)cap) != 0) {
            s->data = nullptr;  // freed above: don't leave it dangling
            s->cap = 0;
            return nullptr;
        }
        s->data = (char*)p;
        s->cap = cap;
    }
    return s->data;
}

}  // namespace

extern "C" {

void* rb_create(int64_t capacity) {
    if (capacity < 1) capacity = 1;
    Ring* rb = new Ring();
    rb->slots = new Slot[capacity]();
    rb->capacity = capacity;
    rb->head = 0;
    rb->closed = false;
    pthread_mutex_init(&rb->mu, nullptr);
    pthread_cond_init(&rb->can_push, nullptr);
    pthread_cond_init(&rb->can_pop, nullptr);
    return rb;
}

void rb_destroy(void* h) {
    Ring* rb = (Ring*)h;
    for (int64_t i = 0; i < rb->capacity; i++) free(rb->slots[i].data);
    delete[] rb->slots;
    pthread_mutex_destroy(&rb->mu);
    pthread_cond_destroy(&rb->can_push);
    pthread_cond_destroy(&rb->can_pop);
    delete rb;
}

// Block until slot (seq % capacity) is free AND seq is within the live
// window [head, head+capacity); copy data in.  Returns 0, or -1 if the
// ring was closed (consumer went away).
int rb_push(void* h, int64_t seq, const void* data, int64_t nbytes) {
    Ring* rb = (Ring*)h;
    Slot* s = &rb->slots[seq % rb->capacity];
    pthread_mutex_lock(&rb->mu);
    while (!rb->closed && (s->full || seq >= rb->head + rb->capacity))
        pthread_cond_wait(&rb->can_push, &rb->mu);
    if (rb->closed) {
        pthread_mutex_unlock(&rb->mu);
        return -1;
    }
    if (!ensure_cap(s, nbytes)) {
        pthread_mutex_unlock(&rb->mu);
        return -2;
    }
    memcpy(s->data, data, (size_t)nbytes);
    s->size = nbytes;
    s->full = true;
    if (seq == rb->head) pthread_cond_broadcast(&rb->can_pop);
    pthread_mutex_unlock(&rb->mu);
    return 0;
}

// Block until the next in-order batch is ready; return its byte size.
// Returns -1 if closed with nothing pending.
int64_t rb_wait_next(void* h) {
    Ring* rb = (Ring*)h;
    pthread_mutex_lock(&rb->mu);
    Slot* s = &rb->slots[rb->head % rb->capacity];
    while (!s->full && !rb->closed)
        pthread_cond_wait(&rb->can_pop, &rb->mu);
    int64_t n = s->full ? s->size : -1;
    pthread_mutex_unlock(&rb->mu);
    return n;
}

// Copy the head batch out (call after rb_wait_next), free the slot,
// advance.  Returns payload size or -1.
int64_t rb_pop(void* h, void* out, int64_t max_bytes) {
    Ring* rb = (Ring*)h;
    pthread_mutex_lock(&rb->mu);
    Slot* s = &rb->slots[rb->head % rb->capacity];
    while (!s->full && !rb->closed)
        pthread_cond_wait(&rb->can_pop, &rb->mu);
    if (!s->full) {  // closed + drained
        pthread_mutex_unlock(&rb->mu);
        return -1;
    }
    int64_t n = s->size;
    if (n > max_bytes) {
        pthread_mutex_unlock(&rb->mu);
        return -2;
    }
    memcpy(out, s->data, (size_t)n);
    s->full = false;
    s->size = 0;
    rb->head++;
    pthread_cond_broadcast(&rb->can_push);
    // wake pop waiters in case the next slot is already full
    pthread_cond_broadcast(&rb->can_pop);
    pthread_mutex_unlock(&rb->mu);
    return n;
}

void rb_close(void* h) {
    Ring* rb = (Ring*)h;
    pthread_mutex_lock(&rb->mu);
    rb->closed = true;
    pthread_cond_broadcast(&rb->can_push);
    pthread_cond_broadcast(&rb->can_pop);
    pthread_mutex_unlock(&rb->mu);
}

int64_t rb_head(void* h) {
    Ring* rb = (Ring*)h;
    pthread_mutex_lock(&rb->mu);
    int64_t v = rb->head;
    pthread_mutex_unlock(&rb->mu);
    return v;
}

}  // extern "C"
