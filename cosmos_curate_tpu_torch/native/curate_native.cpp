// Native runtime support for the streaming engine's object store.
//
// The reference rides Ray's C++ core + plasma store for zero-copy object
// transport (SURVEY.md §1 L0); our engine's equivalent hot path — framing
// task payloads into POSIX shared-memory segments — is implemented here so
// the per-object work is one open/ftruncate/mmap and one gather pass over
// the PEP-574 buffers, with no Python-level slice bookkeeping.
//
// Layout written (must match engine/object_store.py):
//   [u64 payload_len][payload][u64 nbuf][u64 size]*nbuf [buffers...]
//
// Exposed C ABI (ctypes):
//   cn_put(name, payload, payload_len, bufs, sizes, nbuf, total) -> 0/-errno

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapping {
    void* addr = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return addr != MAP_FAILED && addr != nullptr; }
};

Mapping map_segment(const char* name, size_t size, bool create) {
    Mapping m;
    int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
    m.fd = shm_open(name, flags, 0600);
    if (m.fd < 0) return m;
    if (create && ftruncate(m.fd, static_cast<off_t>(size)) != 0) {
        // failure after create must not orphan a half-made segment: the
        // Python fallback will re-create under the SAME name.
        close(m.fd);
        shm_unlink(name);
        m.fd = -1;
        return m;
    }
    m.size = size;
    m.addr = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, m.fd, 0);
    if (!m.ok()) {
        close(m.fd);
        if (create) shm_unlink(name);
        m.fd = -1;
    }
    return m;
}

void unmap(Mapping& m) {
    if (m.ok()) munmap(m.addr, m.size);
    if (m.fd >= 0) close(m.fd);
}

inline void put_u64(uint8_t*& p, uint64_t v) {
    std::memcpy(p, &v, 8);  // little-endian hosts only (TPU VMs are x86/ARM LE)
    p += 8;
}

}  // namespace

extern "C" {

int cn_put(const char* name, const uint8_t* payload, uint64_t payload_len,
           const uint8_t** bufs, const uint64_t* sizes, uint64_t nbuf,
           uint64_t total) {
    Mapping m = map_segment(name, total, /*create=*/true);
    if (!m.ok()) return -errno;
    uint8_t* p = static_cast<uint8_t*>(m.addr);
    put_u64(p, payload_len);
    std::memcpy(p, payload, payload_len);
    p += payload_len;
    put_u64(p, nbuf);
    for (uint64_t i = 0; i < nbuf; ++i) put_u64(p, sizes[i]);
    for (uint64_t i = 0; i < nbuf; ++i) {
        std::memcpy(p, bufs[i], sizes[i]);
        p += sizes[i];
    }
    unmap(m);
    return 0;
}

}  // extern "C"
