#include "socketio.h"

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdlib>
#include <thread>

#include "logging.h"

namespace hvdtpu {

double MonotonicSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- request/response serialization ---------------------------------------

void SerializeRequest(const TensorRequest& r, Writer* w) {
  // handle rides the wire so tombstone error deliveries can echo the owed
  // rank's own submission id back to it (core_api matches it against the
  // outstanding entry to drop stale deliveries after a resubmission).
  w->PutI64(r.handle);
  w->PutString(r.name);
  w->PutI32(static_cast<int32_t>(r.op));
  w->PutI32(static_cast<int32_t>(r.dtype));
  w->PutI32(static_cast<int32_t>(r.reduce_op));
  w->PutI64(r.nbytes);
  w->PutI64Vec(r.shape);
  w->PutI32(r.process_set_id);
  w->PutI32(r.root_rank);
  w->PutF64(r.prescale);
  w->PutF64(r.postscale);
  w->PutI64Vec(r.splits);
  w->PutI32(r.device);
  w->PutString(r.group_key);
  w->PutI32(r.group_size);
}

TensorRequest DeserializeRequest(Reader* r) {
  TensorRequest t;
  t.handle = r->GetI64();
  t.name = r->GetString();
  t.op = static_cast<OpType>(r->GetI32());
  t.dtype = static_cast<DataType>(r->GetI32());
  t.reduce_op = static_cast<ReduceOp>(r->GetI32());
  t.nbytes = r->GetI64();
  t.shape = r->GetI64Vec();
  t.process_set_id = r->GetI32();
  t.root_rank = r->GetI32();
  t.prescale = r->GetF64();
  t.postscale = r->GetF64();
  t.splits = r->GetI64Vec();
  t.device = r->GetI32();
  t.group_key = r->GetString();
  t.group_size = r->GetI32();
  return t;
}

void SerializeResponse(const Response& r, Writer* w) {
  w->PutI32(static_cast<int32_t>(r.op));
  w->PutI32(static_cast<int32_t>(r.dtype));
  w->PutI32(r.process_set_id);
  w->PutString(r.error);
  w->PutU8(r.cache_hit ? 1 : 0);
  w->PutU8(r.hier ? 1 : 0);
  w->PutU8(static_cast<uint8_t>(r.wire_comp));
  w->PutI64(r.seq);
  w->PutI32(r.last_joined);
  w->PutI32(r.target_rank);
  w->PutI32(static_cast<int32_t>(r.metas.size()));
  for (const auto& m : r.metas) SerializeRequest(m, w);
}

Response DeserializeResponse(Reader* r) {
  Response resp;
  resp.op = static_cast<OpType>(r->GetI32());
  resp.dtype = static_cast<DataType>(r->GetI32());
  resp.process_set_id = r->GetI32();
  resp.error = r->GetString();
  resp.cache_hit = r->GetU8() != 0;
  resp.hier = r->GetU8() != 0;
  resp.wire_comp = r->GetU8();
  resp.seq = r->GetI64();
  resp.last_joined = r->GetI32();
  resp.target_rank = r->GetI32();
  int32_t n = r->GetI32();
  resp.metas.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    resp.metas.push_back(DeserializeRequest(r));
    resp.names.push_back(resp.metas.back().name);
  }
  return resp;
}

// ---- Socket ---------------------------------------------------------------

namespace {

// HOROVOD_SOCKET_BUFFER_BYTES: kernel send/recv buffer size for data-plane
// sockets (0 = leave the kernel default).  Oversized buffers hurt on
// cache-constrained hosts (more cold in-flight bytes), so this stays a
// deliberate knob rather than a hardcoded maximum.
void TuneDataSocketBuffers(int fd) {
  static const int bufsz = [] {
    if (const char* env = ::getenv("HOROVOD_SOCKET_BUFFER_BYTES")) {
      char* end = nullptr;
      long long v = std::strtoll(env, &end, 10);
      if (end && *end == '\0' && v >= 0) {
        // Clamp: setsockopt takes int, and the kernel caps at
        // net.core.{w,r}mem_max anyway.
        return static_cast<int>(std::min<long long>(v, 1 << 30));
      }
    }
    return 0;
  }();
  if (bufsz > 0) {
    ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
    ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
  }
}

}  // namespace

Socket::~Socket() { Close(); }

Socket& Socket::operator=(Socket&& o) noexcept {
  if (this != &o) {
    Close();
    fd_ = o.fd_;
    o.fd_ = -1;
  }
  return *this;
}

void Socket::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool Socket::Connect(const std::string& addr, int port, double timeout_s) {
  // Rendezvous addresses may be hostnames (TPU-VM pod metadata hands out
  // names, not IPs); resolution is retried inside the deadline loop because
  // DNS may come up after the worker does, exactly like the listener may.
  sockaddr_in resolved{};
  resolved.sin_family = AF_INET;
  resolved.sin_port = htons(static_cast<uint16_t>(port));
  bool have_addr = ::inet_pton(AF_INET, addr.c_str(), &resolved.sin_addr) == 1;
  double deadline = MonotonicSeconds() + timeout_s;
  while (MonotonicSeconds() < deadline) {
    if (!have_addr) {
      addrinfo hints{};
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      if (::getaddrinfo(addr.c_str(), nullptr, &hints, &res) == 0 && res) {
        resolved.sin_addr =
            reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
        ::freeaddrinfo(res);
        have_addr = true;
      } else {
        HVD_LOG(DEBUG) << "cannot resolve host '" << addr << "' (will retry)";
        std::this_thread::sleep_for(std::chrono::milliseconds(200));
        continue;
      }
    }
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return false;
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    TuneDataSocketBuffers(fd);
    sockaddr_in sa = resolved;
    if (::connect(fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) == 0) {
      fd_ = fd;
      return true;
    }
    ::close(fd);
    // Rendezvous race: the coordinator may not be listening yet.
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
  return false;
}

bool Socket::ConnectOnce(const std::string& addr, int port) {
  last_errno_ = 0;
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, addr.c_str(), &sa.sin_addr) != 1) {
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(addr.c_str(), nullptr, &hints, &res) != 0 || !res) {
      // Name resolution may come up after the worker does, exactly like
      // the listener: report it as retryable.
      last_errno_ = EAGAIN;
      return false;
    }
    sa.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    ::freeaddrinfo(res);
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    last_errno_ = errno;
    return false;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  TuneDataSocketBuffers(fd);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) != 0) {
    last_errno_ = errno;
    ::close(fd);
    return false;
  }
  fd_ = fd;
  return true;
}

bool ConnectErrnoRetryable(int err) {
  switch (err) {
    case ECONNREFUSED:
    case ETIMEDOUT:
    case EHOSTUNREACH:
    case ENETUNREACH:
    case EAGAIN:
    case EINTR:
      return true;
    default:
      return false;
  }
}

bool Socket::SendAll(const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = ::send(fd_, c + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    sent += static_cast<size_t>(r);
  }
  return true;
}

bool Socket::RecvAll(void* p, size_t n) {
  char* c = static_cast<char*>(p);
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd_, c + got, n - got, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    got += static_cast<size_t>(r);
  }
  return true;
}

bool Socket::SendFrame(const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  if (!SendAll(&len, 4)) return false;
  return payload.empty() || SendAll(payload.data(), payload.size());
}

bool Socket::RecvFrame(std::string* payload) {
  uint32_t len = 0;
  if (!RecvAll(&len, 4)) return false;
  payload->resize(len);
  if (len == 0) return true;
  return RecvAll(&(*payload)[0], len);
}

std::string Socket::PeerAddr() const {
  sockaddr_in sa{};
  socklen_t slen = sizeof(sa);
  if (::getpeername(fd_, reinterpret_cast<sockaddr*>(&sa), &slen) != 0) {
    return "";
  }
  char buf[INET_ADDRSTRLEN] = {0};
  if (!::inet_ntop(AF_INET, &sa.sin_addr, buf, sizeof(buf))) return "";
  return buf;
}

void Socket::SetRecvTimeout(double seconds) {
  timeval tv{};
  tv.tv_sec = static_cast<time_t>(seconds);
  tv.tv_usec = static_cast<suseconds_t>((seconds - tv.tv_sec) * 1e6);
  ::setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

namespace {

bool SetNonblocking(int fd, bool on) {
  int flags = ::fcntl(fd, F_GETFL, 0);
  if (flags < 0) return false;
  flags = on ? (flags | O_NONBLOCK) : (flags & ~O_NONBLOCK);
  return ::fcntl(fd, F_SETFL, flags) == 0;
}

}  // namespace

bool DuplexExchange(Socket& send_sock, const std::string& out,
                    Socket& recv_sock, std::string* in,
                    const std::function<bool()>& cancelled) {
  const int sfd = send_sock.fd();
  const int rfd = recv_sock.fd();
  if (sfd < 0 || rfd < 0) return false;

  // Outgoing: 4-byte length prefix + payload (matches Send/RecvFrame).
  std::string sbuf;
  sbuf.reserve(4 + out.size());
  uint32_t slen = static_cast<uint32_t>(out.size());
  sbuf.append(reinterpret_cast<const char*>(&slen), 4);
  sbuf += out;
  size_t sent = 0;

  // Incoming state machine: length prefix, then payload.
  uint32_t rlen = 0;
  size_t rlen_got = 0;
  size_t rgot = 0;
  bool rlen_done = false;
  in->clear();

  if (!SetNonblocking(sfd, true)) return false;
  if (rfd != sfd && !SetNonblocking(rfd, true)) {
    SetNonblocking(sfd, false);
    return false;
  }
  bool ok = true;
  while (ok && (sent < sbuf.size() || !rlen_done || rgot < rlen)) {
    if (cancelled && cancelled()) {
      ok = false;
      break;
    }
    pollfd pfds[2];
    int n = 0;
    const bool want_send = sent < sbuf.size();
    const bool want_recv = !rlen_done || rgot < rlen;
    if (sfd == rfd) {
      pfds[n++] = pollfd{
          sfd,
          static_cast<short>((want_send ? POLLOUT : 0) |
                             (want_recv ? POLLIN : 0)),
          0};
    } else {
      if (want_send) pfds[n++] = pollfd{sfd, POLLOUT, 0};
      if (want_recv) pfds[n++] = pollfd{rfd, POLLIN, 0};
    }
    int rc = ::poll(pfds, n, 200);  // short: re-check cancellation
    if (rc < 0) {
      if (errno == EINTR) continue;
      ok = false;
      break;
    }
    if (rc == 0) continue;  // peer may still be computing toward this step
    for (int i = 0; i < n && ok; ++i) {
      if (pfds[i].revents & POLLNVAL) {
        ok = false;
        break;
      }
      // POLLERR/POLLHUP with a pending send: attempt the send so the socket
      // error surfaces instead of spinning on a dead peer.
      if ((pfds[i].revents & (POLLOUT | POLLERR | POLLHUP)) && want_send &&
          pfds[i].fd == sfd) {
        ssize_t w = ::send(pfds[i].fd, sbuf.data() + sent, sbuf.size() - sent,
                           MSG_NOSIGNAL);
        if (w > 0) {
          sent += static_cast<size_t>(w);
        } else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                   errno != EINTR) {
          ok = false;
          break;
        }
      }
      if ((pfds[i].revents & (POLLIN | POLLHUP | POLLERR)) && want_recv &&
          pfds[i].fd == rfd) {
        if (!rlen_done) {
          ssize_t r = ::recv(pfds[i].fd,
                             reinterpret_cast<char*>(&rlen) + rlen_got,
                             4 - rlen_got, 0);
          if (r > 0) {
            rlen_got += static_cast<size_t>(r);
            if (rlen_got == 4) {
              rlen_done = true;
              in->resize(rlen);
            }
          } else if (r == 0 || (errno != EAGAIN && errno != EWOULDBLOCK &&
                                errno != EINTR)) {
            ok = false;
            break;
          }
        } else if (rgot < rlen) {
          ssize_t r = ::recv(pfds[i].fd, &(*in)[rgot], rlen - rgot, 0);
          if (r > 0) {
            rgot += static_cast<size_t>(r);
          } else if (r == 0 || (errno != EAGAIN && errno != EWOULDBLOCK &&
                                errno != EINTR)) {
            ok = false;
            break;
          }
        }
      }
    }
  }
  SetNonblocking(sfd, false);
  if (rfd != sfd) SetNonblocking(rfd, false);
  return ok;
}

bool ChunkedDuplexExchange(
    Socket& send_sock, const char* send_base, int64_t send_len,
    Socket& recv_sock, int64_t recv_total, int64_t chunk_bytes,
    const std::string& header, char* recv_dest,
    const std::function<void(int64_t off, const char* data, int64_t len)>&
        on_chunk,
    const std::function<bool()>& cancelled, ChunkExchangeError* err) {
  const int sfd = send_sock.fd();
  const int rfd = recv_sock.fd();
  if (err) *err = ChunkExchangeError{ChunkExchangeError::kTransport, "", 0};
  if (sfd < 0 || rfd < 0) return false;
  if (chunk_bytes <= 0) chunk_bytes = 1 << 19;
  const size_t hdr_n = header.size();

  // Send state: per chunk, a small prefix+header scratch, then payload
  // straight out of the caller's buffer (no segment-sized copies).
  std::string shdr;
  size_t shdr_sent = 0;
  int64_t schunk_start = 0;  // payload offset of the current chunk
  int64_t schunk_len = 0;
  int64_t schunk_sent = 0;
  bool schunk_active = false;
  auto arm_send_chunk = [&](int64_t start) {
    if (start >= send_len) {
      schunk_active = false;
      return;
    }
    schunk_start = start;
    schunk_len = std::min<int64_t>(chunk_bytes, send_len - start);
    uint32_t flen = static_cast<uint32_t>(hdr_n + schunk_len);
    shdr.assign(reinterpret_cast<const char*>(&flen), 4);
    shdr += header;
    shdr_sent = 0;
    schunk_sent = 0;
    schunk_active = true;
  };
  arm_send_chunk(0);

  // Recv state machine: frame length prefix -> header -> payload.  The
  // payload length comes from the peer's framing, so the two ends may run
  // different chunk sizes.
  int64_t recv_done = 0;
  uint32_t rlen = 0;
  size_t rlen_got = 0;
  std::string rhdr(hdr_n, '\0');
  size_t rhdr_got = 0;
  int64_t rchunk_len = 0;
  int64_t rchunk_got = 0;
  bool rframe_known = false;  // prefix + header fully read
  std::vector<char> scratch;

  if (!SetNonblocking(sfd, true)) return false;
  if (rfd != sfd && !SetNonblocking(rfd, true)) {
    SetNonblocking(sfd, false);
    return false;
  }
  bool ok = true;
  while (ok && (schunk_active || recv_done < recv_total)) {
    if (cancelled && cancelled()) {
      ok = false;
      break;
    }
    pollfd pfds[2];
    int n = 0;
    const bool want_send = schunk_active;
    const bool want_recv = recv_done < recv_total;
    if (sfd == rfd) {
      pfds[n++] = pollfd{
          sfd,
          static_cast<short>((want_send ? POLLOUT : 0) |
                             (want_recv ? POLLIN : 0)),
          0};
    } else {
      if (want_send) pfds[n++] = pollfd{sfd, POLLOUT, 0};
      if (want_recv) pfds[n++] = pollfd{rfd, POLLIN, 0};
    }
    int rc = ::poll(pfds, n, 200);  // short: re-check cancellation
    if (rc < 0) {
      if (errno == EINTR) continue;
      ok = false;
      break;
    }
    if (rc == 0) continue;  // peer may still be computing toward this step
    for (int i = 0; i < n && ok; ++i) {
      if (pfds[i].revents & POLLNVAL) {
        ok = false;
        break;
      }
      if ((pfds[i].revents & (POLLOUT | POLLERR | POLLHUP)) && want_send &&
          pfds[i].fd == sfd && schunk_active) {
        if (shdr_sent < shdr.size()) {
          ssize_t w = ::send(pfds[i].fd, shdr.data() + shdr_sent,
                             shdr.size() - shdr_sent, MSG_NOSIGNAL);
          if (w > 0) {
            shdr_sent += static_cast<size_t>(w);
          } else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                     errno != EINTR) {
            ok = false;
            break;
          }
        }
        if (shdr_sent == shdr.size() && schunk_sent < schunk_len) {
          ssize_t w = ::send(
              pfds[i].fd, send_base + schunk_start + schunk_sent,
              static_cast<size_t>(schunk_len - schunk_sent), MSG_NOSIGNAL);
          if (w > 0) {
            schunk_sent += w;
          } else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                     errno != EINTR) {
            ok = false;
            break;
          }
        }
        if (shdr_sent == shdr.size() && schunk_sent == schunk_len) {
          arm_send_chunk(schunk_start + schunk_len);
        }
      }
      if ((pfds[i].revents & (POLLIN | POLLHUP | POLLERR)) && want_recv &&
          pfds[i].fd == rfd) {
        // Drain the length prefix AND the header within one wakeup (they
        // are tiny and nearly always arrive in the same segment) — an
        // if/else ladder here would cost an extra poll round-trip per
        // chunk frame.  1 = complete, 0 = would block, -1 = error/EOF.
        auto drain = [&](char* dst, size_t want, size_t& got) -> int {
          while (got < want) {
            ssize_t r = ::recv(pfds[i].fd, dst + got, want - got, 0);
            if (r > 0) {
              got += static_cast<size_t>(r);
              continue;
            }
            if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK ||
                          errno == EINTR)) {
              return 0;
            }
            return -1;
          }
          return 1;
        };
        int pr = 1;
        if (rlen_got < 4) {
          pr = drain(reinterpret_cast<char*>(&rlen), 4, rlen_got);
        }
        if (pr > 0 && rhdr_got < hdr_n) {
          pr = drain(&rhdr[0], hdr_n, rhdr_got);
        }
        if (pr < 0) {
          ok = false;
          break;
        }
        if (!rframe_known && rlen_got == 4 && rhdr_got == hdr_n) {
          if (rhdr != header) {
            if (err) {
              err->kind = ChunkExchangeError::kHeaderMismatch;
              err->got_header = rhdr;
            }
            ok = false;
            break;
          }
          rchunk_len = static_cast<int64_t>(rlen) -
                       static_cast<int64_t>(hdr_n);
          if (rchunk_len <= 0 || rchunk_len > recv_total - recv_done) {
            if (err) {
              err->kind = ChunkExchangeError::kBadLength;
              err->bad_length = rchunk_len;
            }
            ok = false;
            break;
          }
          rchunk_got = 0;
          rframe_known = true;
          if (!recv_dest &&
              static_cast<int64_t>(scratch.size()) < rchunk_len) {
            scratch.resize(static_cast<size_t>(rchunk_len));
          }
        }
        if (rframe_known && rchunk_got < rchunk_len) {
          char* dest = recv_dest ? recv_dest + recv_done + rchunk_got
                                 : scratch.data() + rchunk_got;
          ssize_t r = ::recv(pfds[i].fd, dest,
                             static_cast<size_t>(rchunk_len - rchunk_got),
                             0);
          if (r > 0) {
            rchunk_got += r;
          } else if (r == 0 || (errno != EAGAIN && errno != EWOULDBLOCK &&
                                errno != EINTR)) {
            ok = false;
            break;
          }
        }
        if (rframe_known && rchunk_got == rchunk_len) {
          // Chunk complete: consume it now, overlapping the reduce with
          // whatever the kernel keeps receiving into socket buffers.
          if (on_chunk) {
            on_chunk(recv_done,
                     recv_dest ? recv_dest + recv_done : scratch.data(),
                     rchunk_len);
          }
          recv_done += rchunk_len;
          rlen_got = 0;
          rhdr_got = 0;
          rframe_known = false;
        }
      }
    }
  }
  SetNonblocking(sfd, false);
  if (rfd != sfd) SetNonblocking(rfd, false);
  if (ok && err) err->kind = ChunkExchangeError::kNone;
  return ok;
}

// ---- Listener -------------------------------------------------------------

Listener::~Listener() { Close(); }

void Listener::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool Listener::Listen(const std::string& addr, int port) {
  fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd_ < 0) return false;
  int one = 1;
  ::setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, addr.c_str(), &sa.sin_addr) != 1) return false;
  if (::bind(fd_, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) != 0) {
    HVD_LOG(ERROR) << "bind(" << addr << ":" << port << ") failed: " << errno;
    return false;
  }
  socklen_t slen = sizeof(sa);
  ::getsockname(fd_, reinterpret_cast<sockaddr*>(&sa), &slen);
  port_ = ntohs(sa.sin_port);
  // Non-blocking listener: Accept's poll() provides the wait, and a losing
  // racer among concurrent acceptor threads (the sharded rendezvous) gets
  // EAGAIN back instead of blocking inside ::accept with no connection
  // left.  Backlog 512: an np=512 rendezvous herd SYNs all at once; the
  // worker-side exponential backoff absorbs whatever still overflows.
  int flags = ::fcntl(fd_, F_GETFL, 0);
  if (flags >= 0) ::fcntl(fd_, F_SETFL, flags | O_NONBLOCK);
  return ::listen(fd_, 512) == 0;
}

Socket Listener::Accept(double timeout_s) {
  pollfd pfd{fd_, POLLIN, 0};
  int rc = ::poll(&pfd, 1, static_cast<int>(timeout_s * 1000));
  if (rc <= 0) return Socket();
  int cfd = ::accept(fd_, nullptr, nullptr);
  if (cfd < 0) return Socket();
  int one = 1;
  ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  TuneDataSocketBuffers(cfd);
  return Socket(cfd);
}

}  // namespace hvdtpu
