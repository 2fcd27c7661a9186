// Minimal TCP framing + binary serialization for the control/data planes.
//
// TPU-native analog of the reference's wire layer (horovod/common/wire/ +
// gloo HTTP rendezvous; SURVEY.md §2.1 "Wire messages"): length-prefixed
// frames over blocking sockets, little-endian scalar encoding.
#pragma once

#include <cstdint>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

// ---- byte buffer ----------------------------------------------------------

class Writer {
 public:
  void PutI32(int32_t v) { PutRaw(&v, 4); }
  void PutI64(int64_t v) { PutRaw(&v, 8); }
  void PutF64(double v) { PutRaw(&v, 8); }
  void PutU8(uint8_t v) { PutRaw(&v, 1); }
  void PutString(const std::string& s) {
    PutI32(static_cast<int32_t>(s.size()));
    PutRaw(s.data(), s.size());
  }
  void PutI64Vec(const std::vector<int64_t>& v) {
    PutI32(static_cast<int32_t>(v.size()));
    for (int64_t x : v) PutI64(x);
  }
  void PutRaw(const void* p, size_t n) {
    const char* c = static_cast<const char*>(p);
    buf_.insert(buf_.end(), c, c + n);
  }
  const std::string& data() const { return buf_; }
  std::string&& Take() { return std::move(buf_); }

 private:
  std::string buf_;
};

class Reader {
 public:
  Reader(const char* data, size_t size) : data_(data), size_(size) {}
  explicit Reader(const std::string& s) : data_(s.data()), size_(s.size()) {}
  int32_t GetI32() { int32_t v; Get(&v, 4); return v; }
  int64_t GetI64() { int64_t v; Get(&v, 8); return v; }
  double GetF64() { double v; Get(&v, 8); return v; }
  uint8_t GetU8() { uint8_t v; Get(&v, 1); return v; }
  std::string GetString() {
    int32_t n = GetI32();
    std::string s(data_ + pos_, n);
    pos_ += n;
    return s;
  }
  std::vector<int64_t> GetI64Vec() {
    int32_t n = GetI32();
    std::vector<int64_t> v(n);
    for (int32_t i = 0; i < n; ++i) v[i] = GetI64();
    return v;
  }
  bool ok() const { return ok_; }
  size_t remaining() const { return size_ - pos_; }
  // Zero-copy view of the unread tail (bulk data-plane payloads).
  const char* cursor() const { return data_ + pos_; }

 private:
  void Get(void* out, size_t n) {
    if (pos_ + n > size_) { ok_ = false; std::memset(out, 0, n); return; }
    std::memcpy(out, data_ + pos_, n);
    pos_ += n;
  }
  const char* data_;
  size_t size_;
  size_t pos_ = 0;
  bool ok_ = true;
};

// ---- request/response serialization ---------------------------------------

void SerializeRequest(const TensorRequest& r, Writer* w);
TensorRequest DeserializeRequest(Reader* r);
void SerializeResponse(const Response& r, Writer* w);
Response DeserializeResponse(Reader* r);

// ---- sockets --------------------------------------------------------------

// Blocking TCP socket with u32-length-prefixed frames.  All methods return
// false on peer close / error (callers treat that as ABORTED).
class Socket {
 public:
  Socket() = default;
  explicit Socket(int fd) : fd_(fd) {}
  ~Socket();
  Socket(const Socket&) = delete;
  Socket& operator=(const Socket&) = delete;
  Socket(Socket&& o) noexcept : fd_(o.fd_) { o.fd_ = -1; }
  Socket& operator=(Socket&& o) noexcept;

  bool Connect(const std::string& addr, int port, double timeout_s);
  // Single connect attempt, no internal retry loop: the caller owns the
  // retry policy (rendezvous exponential backoff).  On failure last_errno()
  // holds the connect errno (resolve failures report EAGAIN — retryable,
  // DNS may come up after the worker).
  bool ConnectOnce(const std::string& addr, int port);
  int last_errno() const { return last_errno_; }
  bool SendFrame(const std::string& payload);
  bool RecvFrame(std::string* payload);
  // Raw (unframed) helpers for bulk data-plane payloads.
  bool SendAll(const void* p, size_t n);
  bool RecvAll(void* p, size_t n);
  // Peer IPv4 address ("1.2.3.4") of a connected socket, "" on error.
  std::string PeerAddr() const;
  // Kernel receive timeout; 0 restores blocking reads.  Used to bound the
  // rendezvous HELLO read so a connect-and-stay-silent stray cannot wedge
  // the accept loop.
  void SetRecvTimeout(double seconds);
  void Close();
  bool valid() const { return fd_ >= 0; }
  int fd() const { return fd_; }

 private:
  int fd_ = -1;
  int last_errno_ = 0;
};

// Whether a failed connect attempt is worth retrying: refused/timed-out/
// unreachable mean the peer may simply not be up yet (startup race);
// permission and address-family errors will never heal and must fail
// immediately with a named cause.
bool ConnectErrnoRetryable(int err);

// Simultaneously send one frame on `send_sock` and receive one frame from
// `recv_sock` without deadlocking — ring/pairwise collective steps have every
// member sending first, so blocking sends can gridlock once payloads exceed
// the kernel socket buffers (the reason Gloo's ring algorithms are
// event-driven).  The two sockets may be the same object (2-member ring).
// `cancelled` is polled between progress events; returning true aborts.
// Returns false on peer failure or cancellation.
bool DuplexExchange(Socket& send_sock, const std::string& out,
                    Socket& recv_sock, std::string* in,
                    const std::function<bool()>& cancelled);

// Chunk-pipelined duplex segment exchange: streams `send_len` payload bytes
// from `send_base` to `send_sock` as a sequence of length-prefixed chunk
// frames (u32 length | `header` bytes | payload), while receiving the
// peer's equally-framed stream of `recv_total` payload bytes from
// `recv_sock`.  This is the Gloo-style segmented ring step: because the
// payload is sent directly from the caller's buffer and received directly
// into `recv_dest` (or handed chunk-by-chunk to `on_chunk` for in-flight
// reduction), a ring hop costs zero full-segment copies and the reduce
// overlaps the wire transfer instead of waiting for the whole segment.
//
// - Each incoming chunk's header must byte-equal `header` (both ends of a
//   ring step carry the same [seq|tag]); on mismatch `err` carries the
//   got-header.  Bad frame lengths and transport failures are reported as
//   their own error kinds so desync messages name the real cause.
// - `recv_dest`, when non-null, receives payload bytes at their cumulative
//   offset (zero-copy).  Otherwise chunks land in an internal scratch and
//   `on_chunk(offset, data, len)` is invoked as each completes, in order.
// - The peer's chunk size is discovered per-frame, so the two ends may use
//   different NONZERO HOROVOD_RING_CHUNK_BYTES settings.  0 (the legacy
//   whole-segment protocol) is a different wire format and must be uniform
//   across ranks.
// - The two sockets may be the same object (2-member ring).
struct ChunkExchangeError {
  enum Kind { kNone, kTransport, kHeaderMismatch, kBadLength };
  Kind kind = kNone;
  std::string got_header;  // kHeaderMismatch: the peer's header bytes
  int64_t bad_length = 0;  // kBadLength: the offending payload length
};

bool ChunkedDuplexExchange(
    Socket& send_sock, const char* send_base, int64_t send_len,
    Socket& recv_sock, int64_t recv_total, int64_t chunk_bytes,
    const std::string& header, char* recv_dest,
    const std::function<void(int64_t off, const char* data, int64_t len)>&
        on_chunk,
    const std::function<bool()>& cancelled, ChunkExchangeError* err);

// Listening socket; Accept returns connected Sockets.
class Listener {
 public:
  // Binds to addr:port; if port==0 an ephemeral port is chosen and stored.
  bool Listen(const std::string& addr, int port);
  // Poll + accept, bounded by timeout_s; returns an invalid Socket on
  // timeout or when another thread won the connection.  Safe to call from
  // multiple threads at once (the fd is non-blocking, so losing racers get
  // EAGAIN, not a stuck ::accept) — the sharded rendezvous
  // (HOROVOD_RENDEZVOUS_ACCEPTORS) relies on this.
  Socket Accept(double timeout_s);
  int port() const { return port_; }
  void Close();
  ~Listener();

 private:
  int fd_ = -1;
  int port_ = 0;
};

}  // namespace hvdtpu
