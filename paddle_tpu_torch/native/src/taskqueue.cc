// Fault-tolerant task-queue master — the TPU-native equivalent of the
// reference's Go master service (reference: go/master/service.go:140-481:
// todo/pending/done queues, task lease timeout checkTimeoutFunc:341,
// retry-then-discard processFailedTask:313, pass barriers GetTask:368,
// snapshot/recover :166,207, save-model election RequestSaveModel:481).
//
// Core is an in-process C-ABI object (Python binds via ctypes); a
// length-framed TCP service over the same object replaces the Go RPC so
// multiple trainer processes can share one master.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <memory>

namespace {

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Task {
  uint64_t id = 0;
  std::string payload;
  int failures = 0;
  uint16_t epoch = 0;  // bumped per lease; stale handles can't act
};

// Lease handles pack (epoch << 48 | id) so a finish/fail from a worker
// whose lease timed out and was re-issued to another worker is detected
// as stale instead of acting on the new lease.
constexpr uint64_t kIdMask = (1ull << 48) - 1;

uint64_t make_handle(const Task& t) {
  return (static_cast<uint64_t>(t.epoch) << 48) | t.id;
}


// Hard cap on task payloads: the get-task wire path and in-process
// bindings use fixed 1MB buffers. Payloads are small task specs (file
// chunk ranges), never data.
constexpr uint64_t kMaxPayload = 1u << 20;

// get_task statuses (shared with the Python client)
enum Status : uint8_t {
  OK = 0,
  NOT_STARTED = 1,   // start() not called yet (ErrPassBefore)
  PENDING_WAIT = 2,  // todo drained, leases outstanding — retry later
  PASS_END = 3,      // every task done/discarded (ErrPassAfter)
};

struct Queue {
  std::mutex mu;
  std::deque<Task> todo;
  std::map<uint64_t, std::pair<Task, int64_t>> pending;  // id -> (task, deadline)
  std::vector<Task> done, discarded;
  uint64_t next_id = 1;
  int64_t timeout_ms = 60000;
  int max_retries = 3;
  int64_t pass = -1;  // -1 until start()
  // save-model election
  int64_t save_grant_trainer = -1;
  int64_t save_grant_expires = 0;

  void check_timeouts_locked() {
    int64_t t = now_ms();
    for (auto it = pending.begin(); it != pending.end();) {
      if (it->second.second <= t) {
        Task task = std::move(it->second.first);
        it = pending.erase(it);
        task.failures++;
        if (task.failures > max_retries) {
          discarded.push_back(std::move(task));
        } else {
          todo.push_back(std::move(task));
        }
      } else {
        ++it;
      }
    }
  }
};

// True if the bare id exists in any terminal/requeued container — used
// to tell a stale-but-known handle (tolerated no-op) from a bogus id.
bool known_id_locked(Queue* q, uint64_t bare_id) {
  for (const auto& t : q->todo)
    if (t.id == bare_id) return true;
  for (const auto& d : q->done)
    if (d.id == bare_id) return true;
  for (const auto& t : q->discarded)
    if (t.id == bare_id) return true;
  return false;
}

// ---- snapshot format: magic+version header, u64 pass, then
// per-section counts + tasks. The version gates task-record layout
// changes (e.g. the epoch field) so an old-format snapshot fails with a
// clean error instead of misparsing. ----

constexpr uint32_t kSnapMagic = 0x50545153;  // "PTQS"
constexpr uint32_t kSnapVersion = 2;         // v2: task records carry epoch

void write_task(FILE* f, const Task& t) {
  uint64_t len = t.payload.size();
  fwrite(&t.id, 8, 1, f);
  fwrite(&t.failures, 4, 1, f);
  // epoch persists so lease handles issued before a snapshot can't
  // collide with fresh leases after recovery
  uint32_t epoch = t.epoch;
  fwrite(&epoch, 4, 1, f);
  fwrite(&len, 8, 1, f);
  if (len) fwrite(t.payload.data(), len, 1, f);
}

bool read_task(FILE* f, Task* t) {
  uint64_t len;
  uint32_t epoch;
  if (fread(&t->id, 8, 1, f) != 1 || fread(&t->failures, 4, 1, f) != 1 ||
      fread(&epoch, 4, 1, f) != 1 || fread(&len, 8, 1, f) != 1)
    return false;
  t->epoch = static_cast<uint16_t>(epoch);
  t->payload.resize(len);
  return len == 0 || fread(&t->payload[0], len, 1, f) == 1;
}

}  // namespace

extern "C" {

void* tq_create(int64_t timeout_ms, int max_retries) {
  auto* q = new Queue();
  if (timeout_ms > 0) q->timeout_ms = timeout_ms;
  if (max_retries >= 0) q->max_retries = max_retries;
  return q;
}

void tq_destroy(void* h) { delete static_cast<Queue*>(h); }

// Returns the new task id, or 0 if the payload exceeds kMaxPayload.
uint64_t tq_add_task(void* h, const char* payload, uint64_t len) {
  auto* q = static_cast<Queue*>(h);
  if (len > kMaxPayload) return 0;
  std::lock_guard<std::mutex> g(q->mu);
  Task t;
  t.id = q->next_id++;
  uint64_t id = t.id;
  t.payload.assign(payload, len);
  q->todo.push_back(std::move(t));
  return id;
}

void tq_start(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  if (q->pass < 0) q->pass = 0;
}

// Fills *id; payload copied into buf (up to buf_cap); *payload_len is the
// full length. Returns a Status.
uint8_t tq_get_task(void* h, uint64_t* id, char* buf, uint64_t buf_cap,
                    uint64_t* payload_len) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  if (q->pass < 0) return NOT_STARTED;
  q->check_timeouts_locked();
  if (q->todo.empty()) {
    return q->pending.empty() ? PASS_END : PENDING_WAIT;
  }
  Task t = std::move(q->todo.front());
  q->todo.pop_front();
  t.epoch++;
  *id = make_handle(t);
  *payload_len = t.payload.size();
  if (buf && buf_cap >= t.payload.size() && !t.payload.empty())
    memcpy(buf, t.payload.data(), t.payload.size());
  q->pending[t.id] = {std::move(t), now_ms() + q->timeout_ms};
  return OK;
}

// 0 ok; 1 stale-but-known no-op (already done, lease timed out and the
// task was re-queued, or the handle's lease epoch was superseded — the
// Go master likewise tolerates stale finishes); -1 truly unknown id.
int tq_finish_task(void* h, uint64_t handle) {
  auto* q = static_cast<Queue*>(h);
  uint64_t id = handle & kIdMask;
  std::lock_guard<std::mutex> g(q->mu);
  auto it = q->pending.find(id);
  if (it == q->pending.end())
    return known_id_locked(q, id) ? 1 : -1;
  if (make_handle(it->second.first) != handle) return 1;  // superseded lease
  q->done.push_back(std::move(it->second.first));
  q->pending.erase(it);
  return 0;
}

// Same stale-handle tolerance as tq_finish_task.
int tq_fail_task(void* h, uint64_t handle) {
  auto* q = static_cast<Queue*>(h);
  uint64_t id = handle & kIdMask;
  std::lock_guard<std::mutex> g(q->mu);
  auto it = q->pending.find(id);
  if (it == q->pending.end())
    return known_id_locked(q, id) ? 1 : -1;
  if (make_handle(it->second.first) != handle) return 1;  // superseded lease
  Task t = std::move(it->second.first);
  q->pending.erase(it);
  t.failures++;
  if (t.failures > q->max_retries) {
    q->discarded.push_back(std::move(t));
  } else {
    q->todo.push_front(std::move(t));  // retry soon, as the Go master does
  }
  return 0;
}

// Recycle done (+discarded, with reset failure counts) into todo for the
// next pass. Returns the new pass number, or -1 if leases are still
// outstanding (callers must drain the pass first).
int64_t tq_next_pass(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  q->check_timeouts_locked();
  if (!q->pending.empty() || !q->todo.empty()) return -1;
  for (auto* src : {&q->done, &q->discarded}) {
    for (auto& t : *src) {
      t.failures = 0;
      q->todo.push_back(std::move(t));
    }
    src->clear();
  }
  return ++q->pass;
}

int64_t tq_pass(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  return q->pass;
}

void tq_counts(void* h, uint64_t* todo, uint64_t* pending, uint64_t* done,
               uint64_t* discarded) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  q->check_timeouts_locked();
  *todo = q->todo.size();
  *pending = q->pending.size();
  *done = q->done.size();
  *discarded = q->discarded.size();
}

// Save-model election (reference: go/master/service.go:481 — exactly one
// trainer should save per checkpoint window). Returns 1 if this trainer
// holds the grant, 0 otherwise.
int tq_request_save_model(void* h, int64_t trainer_id, int64_t ttl_ms) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  int64_t t = now_ms();
  if (q->save_grant_trainer == trainer_id && q->save_grant_expires > t) {
    q->save_grant_expires = t + ttl_ms;
    return 1;
  }
  if (q->save_grant_expires <= t) {
    q->save_grant_trainer = trainer_id;
    q->save_grant_expires = t + ttl_ms;
    return 1;
  }
  return 0;
}

// ---- snapshot / recover (reference: go/master/service.go:166,207 —
// gob+gzip to etcd there; binary file here) ----

int tq_snapshot(void* h, const char* path) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  q->check_timeouts_locked();
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fwrite(&kSnapMagic, 4, 1, f);
  fwrite(&kSnapVersion, 4, 1, f);
  fwrite(&q->pass, 8, 1, f);
  fwrite(&q->next_id, 8, 1, f);
  // pending tasks snapshot back into todo: a recovered master re-leases
  uint64_t n_todo = q->todo.size() + q->pending.size();
  uint64_t n_done = q->done.size(), n_disc = q->discarded.size();
  fwrite(&n_todo, 8, 1, f);
  for (const auto& t : q->todo) write_task(f, t);
  for (const auto& kv : q->pending) write_task(f, kv.second.first);
  fwrite(&n_done, 8, 1, f);
  for (const auto& t : q->done) write_task(f, t);
  fwrite(&n_disc, 8, 1, f);
  for (const auto& t : q->discarded) write_task(f, t);
  int rc = ferror(f) ? -1 : 0;
  fclose(f);
  return rc;
}

int tq_restore(void* h, const char* path) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> g(q->mu);
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0, version = 0;
  if (fread(&magic, 4, 1, f) != 1 || fread(&version, 4, 1, f) != 1 ||
      magic != kSnapMagic || version != kSnapVersion) {
    fclose(f);
    return -3;  // unrecognized or incompatible snapshot format
  }
  Queue fresh;
  uint64_t n_todo, n_done, n_disc;
  bool ok = fread(&fresh.pass, 8, 1, f) == 1 &&
            fread(&fresh.next_id, 8, 1, f) == 1 &&
            fread(&n_todo, 8, 1, f) == 1;
  if (ok)
    for (uint64_t i = 0; i < n_todo && ok; i++) {
      Task t;
      ok = read_task(f, &t);
      if (ok) fresh.todo.push_back(std::move(t));
    }
  ok = ok && fread(&n_done, 8, 1, f) == 1;
  if (ok)
    for (uint64_t i = 0; i < n_done && ok; i++) {
      Task t;
      ok = read_task(f, &t);
      if (ok) fresh.done.push_back(std::move(t));
    }
  ok = ok && fread(&n_disc, 8, 1, f) == 1;
  if (ok)
    for (uint64_t i = 0; i < n_disc && ok; i++) {
      Task t;
      ok = read_task(f, &t);
      if (ok) fresh.discarded.push_back(std::move(t));
    }
  fclose(f);
  if (!ok) return -2;
  q->todo = std::move(fresh.todo);
  q->pending.clear();
  q->done = std::move(fresh.done);
  q->discarded = std::move(fresh.discarded);
  q->pass = fresh.pass;
  q->next_id = fresh.next_id;
  return 0;
}

// ---- TCP service over the same queue (replaces the Go RPC layer) ----
//
// Frame: u32 length, then payload. Request payload: u8 opcode + args.
// Response payload: u8 status + body. Integers little-endian.

namespace {

enum Op : uint8_t {
  OP_GET = 1,        // -> status, u64 id, payload
  OP_FINISH = 2,     // u64 id -> status
  OP_FAIL = 3,       // u64 id -> status
  OP_NEXT_PASS = 4,  // -> status, i64 pass
  OP_COUNTS = 5,     // -> status, 4 x u64
  OP_SAVE_ELECT = 6, // i64 trainer, i64 ttl -> status, u8 granted
  OP_ADD = 7,        // payload -> status, u64 id
  OP_START = 8,      // -> status
  OP_PASS = 9,       // -> status, i64 pass
};

struct Worker {
  std::thread thr;
  std::shared_ptr<std::atomic<bool>> done;
};

struct Server {
  Queue* q = nullptr;
  int listen_fd = -1;
  std::atomic<bool> stop{false};
  std::thread thr;
  // touched only by the accept thread (until it is joined in stop)
  std::vector<Worker> workers;
  std::mutex conn_mu;
  std::vector<int> conn_fds;  // open client fds, shut down on stop
};

bool read_full(int fd, void* buf, size_t len) {
  auto* p = static_cast<char*>(buf);
  while (len) {
    ssize_t n = read(fd, p, len);
    if (n <= 0) return false;
    p += n;
    len -= n;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t len) {
  auto* p = static_cast<const char*>(buf);
  while (len) {
    ssize_t n = write(fd, p, len);
    if (n <= 0) return false;
    p += n;
    len -= n;
  }
  return true;
}

void append_u64(std::string* s, uint64_t v) {
  s->append(reinterpret_cast<const char*>(&v), 8);
}

// Minimum request payload size (incl. opcode byte) per opcode; ops not
// listed take opcode-only (or, for OP_ADD, any length).
size_t min_req_len(uint8_t op) {
  switch (op) {
    case OP_FINISH:
    case OP_FAIL:
      return 9;
    case OP_SAVE_ELECT:
      return 17;
    default:
      return 1;
  }
}

void handle_conn(Server* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint32_t len;
    if (!read_full(fd, &len, 4) || len == 0 || len > (64u << 20)) break;
    std::string req(len, '\0');
    if (!read_full(fd, &req[0], len)) break;
    uint8_t op = static_cast<uint8_t>(req[0]);
    std::string resp;
    Queue* q = srv->q;
    if (req.size() < min_req_len(op)) {
      resp.push_back(static_cast<char>(254));
      uint32_t rl = static_cast<uint32_t>(resp.size());
      if (!write_full(fd, &rl, 4) || !write_full(fd, resp.data(), rl)) break;
      continue;
    }
    switch (op) {
      case OP_GET: {
        uint64_t id = 0, plen = 0;
        std::string buf(kMaxPayload, '\0');
        uint8_t st = tq_get_task(q, &id, &buf[0], buf.size(), &plen);
        resp.push_back(static_cast<char>(st));
        if (st == OK) {
          append_u64(&resp, id);
          resp.append(buf.data(), std::min<uint64_t>(plen, buf.size()));
        }
        break;
      }
      case OP_FINISH:
      case OP_FAIL: {
        uint64_t id;
        memcpy(&id, req.data() + 1, 8);
        int rc = op == OP_FINISH ? tq_finish_task(q, id) : tq_fail_task(q, id);
        resp.push_back(rc < 0 ? 255 : 0);
        break;
      }
      case OP_NEXT_PASS: {
        int64_t p = tq_next_pass(q);
        resp.push_back(0);
        append_u64(&resp, static_cast<uint64_t>(p));
        break;
      }
      case OP_COUNTS: {
        uint64_t a, b, c, d;
        tq_counts(q, &a, &b, &c, &d);
        resp.push_back(0);
        append_u64(&resp, a);
        append_u64(&resp, b);
        append_u64(&resp, c);
        append_u64(&resp, d);
        break;
      }
      case OP_SAVE_ELECT: {
        int64_t trainer, ttl;
        memcpy(&trainer, req.data() + 1, 8);
        memcpy(&ttl, req.data() + 9, 8);
        int granted = tq_request_save_model(q, trainer, ttl);
        resp.push_back(0);
        resp.push_back(static_cast<char>(granted));
        break;
      }
      case OP_ADD: {
        uint64_t id = tq_add_task(q, req.data() + 1, req.size() - 1);
        resp.push_back(id == 0 ? 255 : 0);  // 0 = payload too large
        append_u64(&resp, id);
        break;
      }
      case OP_START:
        tq_start(q);
        resp.push_back(0);
        break;
      case OP_PASS: {
        resp.push_back(0);
        append_u64(&resp, static_cast<uint64_t>(tq_pass(q)));
        break;
      }
      default:
        resp.push_back(254);
    }
    uint32_t rlen = static_cast<uint32_t>(resp.size());
    if (!write_full(fd, &rlen, 4) || !write_full(fd, resp.data(), rlen)) break;
  }
  {
    std::lock_guard<std::mutex> g(srv->conn_mu);
    auto& v = srv->conn_fds;
    v.erase(std::remove(v.begin(), v.end(), fd), v.end());
  }
  close(fd);
}

}  // namespace

// Returns an opaque server handle (nullptr on bind failure). Port 0 picks
// a free port; tq_serve_port reports the bound port.
void* tq_serve_start(void* h, int port) {
  auto* srv = new Server();
  srv->q = static_cast<Queue*>(h);
  srv->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      listen(srv->listen_fd, 64) < 0) {
    close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  srv->thr = std::thread([srv] {
    while (!srv->stop.load()) {
      int fd = accept(srv->listen_fd, nullptr, nullptr);
      if (fd < 0) break;
      {
        std::lock_guard<std::mutex> g(srv->conn_mu);
        srv->conn_fds.push_back(fd);
      }
      // reap finished workers so a long-lived master with churning
      // trainer connections doesn't accumulate unjoined threads
      auto& ws = srv->workers;
      for (auto it = ws.begin(); it != ws.end();) {
        if (it->done->load()) {
          it->thr.join();
          it = ws.erase(it);
        } else {
          ++it;
        }
      }
      Worker w;
      w.done = std::make_shared<std::atomic<bool>>(false);
      auto done = w.done;
      w.thr = std::thread([srv, fd, done] {
        handle_conn(srv, fd);
        done->store(true);
      });
      ws.push_back(std::move(w));
    }
  });
  return srv;
}

int tq_serve_port(void* sh) {
  auto* srv = static_cast<Server*>(sh);
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len) <
      0)
    return -1;
  return ntohs(addr.sin_port);
}

void tq_serve_stop(void* sh) {
  auto* srv = static_cast<Server*>(sh);
  srv->stop.store(true);
  shutdown(srv->listen_fd, SHUT_RDWR);
  close(srv->listen_fd);
  if (srv->thr.joinable()) srv->thr.join();
  {
    // unblock workers parked in read_full on live client connections
    std::lock_guard<std::mutex> g(srv->conn_mu);
    for (int fd : srv->conn_fds) shutdown(fd, SHUT_RDWR);
  }
  for (auto& w : srv->workers)
    if (w.thr.joinable()) w.thr.join();
  delete srv;
}

}  // extern "C"
