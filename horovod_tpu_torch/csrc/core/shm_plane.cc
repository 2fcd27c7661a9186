#include "shm_plane.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>

#include "flight_recorder.h"
#include "logging.h"

namespace hvdtpu {

namespace {
constexpr int64_t kGrowQuantum = 2 << 20;  // 2 MiB ftruncate granularity

int64_t RoundUp(int64_t n) {
  return (n + kGrowQuantum - 1) / kGrowQuantum * kGrowQuantum;
}
}  // namespace

// The destructor unlinks unconditionally (not only for the creator): if
// the creating rank is SIGKILLed mid-job, the next elastic generation
// opens a differently-named region (new rendezvous port), so nobody would
// ever unlink the orphan — the survivors' teardown must.  Unlinking a
// name other members still have mapped is safe (POSIX keeps the mapping),
// and a later same-named incarnation re-creates after its own
// stale-unlink, so a racing unlink at worst downgrades that set to the
// TCP ring via the AND-voted open verdict.
ShmRegion::~ShmRegion() { Close(true); }

Status ShmRegion::Open(const std::string& name, bool creator) {
  name_ = name;
  creator_ = creator;
  if (creator) {
    ::shm_unlink(name.c_str());  // stale region from a killed job
    fd_ = ::shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  } else {
    fd_ = ::shm_open(name.c_str(), O_RDWR, 0600);
  }
  if (fd_ < 0) {
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "shm_open(" + name + ") failed");
  }
  int64_t initial = RoundUp(kHeaderBytes + kGrowQuantum);
  if (creator && ::ftruncate(fd_, initial) != 0) {
    Close(true);
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "ftruncate(" + name + ") failed");
  }
  if (!creator) {
    struct stat st {};
    if (::fstat(fd_, &st) != 0 || st.st_size < initial) {
      Close(false);
      return Status::Error(StatusCode::PRECONDITION_ERROR,
                           "shm region " + name + " has unexpected size");
    }
  }
  map_ = ::mmap(nullptr, initial, PROT_READ | PROT_WRITE, MAP_SHARED, fd_, 0);
  if (map_ == MAP_FAILED) {
    map_ = nullptr;
    Close(creator);
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "mmap(" + name + ") failed");
  }
  cap_ = initial;
  if (FlightOn()) FlightRecord(kFlightShmMap, 0, cap_);
  return Status::OK();
}

Status ShmRegion::EnsureCapacity(int64_t data_bytes, bool creator,
                                 const std::function<Status()>& barrier) {
  int64_t required = kHeaderBytes + data_bytes;
  if (required <= cap_) return Status::OK();
  int64_t new_cap = RoundUp(std::max(required, cap_ * 2));
  // No reader may still use the old mapping, and nobody may remap before
  // the creator's ftruncate: two barriers bracket the grow.
  Status st = barrier();
  if (!st.ok()) return st;
  if (creator && ::ftruncate(fd_, new_cap) != 0) {
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "shm grow ftruncate(" + name_ + ") failed");
  }
  st = barrier();
  if (!st.ok()) return st;
  ::munmap(map_, cap_);
  map_ = ::mmap(nullptr, new_cap, PROT_READ | PROT_WRITE, MAP_SHARED, fd_, 0);
  if (map_ == MAP_FAILED) {
    map_ = nullptr;
    return Status::Error(StatusCode::PRECONDITION_ERROR,
                         "shm grow mmap(" + name_ + ") failed");
  }
  cap_ = new_cap;
  if (FlightOn()) FlightRecord(kFlightShmMap, 1, cap_);
  return Status::OK();
}

void ShmRegion::Close(bool unlink) {
  if (map_ != nullptr) {
    ::munmap(map_, cap_);
    map_ = nullptr;
  }
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
  if (unlink && !name_.empty()) ::shm_unlink(name_.c_str());
  cap_ = 0;
}

}  // namespace hvdtpu
