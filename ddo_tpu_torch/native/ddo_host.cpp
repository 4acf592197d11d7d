// Native host-side search runtime of ddo_tpu_torch: the port's own copy
// of ddo_tpu/native/ddo_host.cpp, unchanged below this header.
//
// The reference's performance-critical search structures are Rust
// (NoDupFringe: ddo/src/implementation/fringe/no_duplicate.rs,
//  SimpleCache: ddo/src/implementation/cache/simple.rs).  This module is
// their C++ counterpart, driving the host side of the device superstep:
//  * a state-deduplicated best-first fringe ordered by (ub, value, score)
//    with the duplicate-push merge rule (max ub, longer path wins);
//  * a per-depth threshold cache with the monotone update and the
//    must-explore rule;
//  * batch APIs so the Python solver crosses the FFI once per superstep.
//
// Keys are fixed-width int32 column vectors (the engine's canonical
// state packing); path payloads are dense int32[n] value arrays + bool
// masks.

#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct KeyHash {
    size_t operator()(const std::vector<int32_t>& k) const {
        size_t h = 1469598103934665603ull;
        for (int32_t v : k) {
            h ^= static_cast<uint32_t>(v);
            h *= 1099511628211ull;
        }
        return h;
    }
};

struct Node {
    std::vector<int32_t> key;
    int32_t depth;
    int32_t value;
    int32_t ub;
    int64_t score;
    std::vector<int32_t> path_vals;
    std::vector<uint8_t> path_set;
    uint64_t stamp;  // freshness for lazy deletion; 0 = dead slot
};

// Heap entries never hold pointers into containers: nodes live in a stable
// arena (std::deque never relocates elements) and are addressed by index.
// An entry is valid only while its stamp matches the arena node's stamp —
// popped/merged nodes bump the stamp, lazily invalidating stale entries.
struct HeapEntry {
    int32_t ub;
    int32_t value;
    int64_t score;
    uint64_t stamp;  // doubles as FIFO tiebreak (globally unique)
    uint32_t idx;    // arena slot

    bool operator<(const HeapEntry& o) const {
        // max-heap by (ub, value, score); FIFO on full ties
        if (ub != o.ub) return ub < o.ub;
        if (value != o.value) return value < o.value;
        if (score != o.score) return score < o.score;
        return stamp > o.stamp;
    }
};

struct DepthKey {
    int32_t depth;
    std::vector<int32_t> key;
    bool operator==(const DepthKey& o) const {
        return depth == o.depth && key == o.key;
    }
};

struct DepthKeyHash {
    size_t operator()(const DepthKey& k) const {
        return KeyHash()(k.key) * 31 + static_cast<size_t>(k.depth);
    }
};

struct Threshold {
    int32_t value;
    uint8_t explored;
};

struct Solver {
    int n_vars;
    int key_cols;
    uint64_t seq = 0;
    // fringe
    std::deque<Node> arena;               // stable storage, slots recycled
    std::vector<uint32_t> free_slots;
    std::unordered_map<DepthKey, uint32_t, DepthKeyHash> live;  // -> arena idx
    std::priority_queue<HeapEntry> heap;
    // cache: one map per depth
    std::vector<std::unordered_map<std::vector<int32_t>, Threshold, KeyHash>> cache;
};

}  // namespace

extern "C" {

void* ddo_new(int n_vars, int key_cols) {
    auto* s = new Solver();
    s->n_vars = n_vars;
    s->key_cols = key_cols;
    s->cache.resize(n_vars + 1);
    return s;
}

void ddo_free(void* h) { delete static_cast<Solver*>(h); }

// ---------------------------------------------------------------- fringe
void fringe_push_batch(void* h, int count, const int32_t* keys,
                       const int32_t* depths, const int32_t* values,
                       const int32_t* ubs, const int64_t* scores,
                       const int32_t* path_vals, const uint8_t* path_set) {
    auto* s = static_cast<Solver*>(h);
    const int K = s->key_cols, n = s->n_vars;
    for (int i = 0; i < count; ++i) {
        DepthKey dk{depths[i],
                    std::vector<int32_t>(keys + i * K, keys + (i + 1) * K)};
        auto it = s->live.find(dk);
        uint64_t stamp = ++s->seq;
        if (it != s->live.end()) {
            // duplicate merge rule (no_duplicate.rs:96-117)
            Node& cur = s->arena[it->second];
            int32_t new_ub = std::max(cur.ub, ubs[i]);
            if (values[i] > cur.value) {
                cur.value = values[i];
                cur.score = scores[i];
                cur.path_vals.assign(path_vals + i * n, path_vals + (i + 1) * n);
                cur.path_set.assign(path_set + i * n, path_set + (i + 1) * n);
            }
            cur.ub = new_ub;
            cur.stamp = stamp;
            s->heap.push({cur.ub, cur.value, cur.score, stamp, it->second});
        } else {
            uint32_t idx;
            if (!s->free_slots.empty()) {
                idx = s->free_slots.back();
                s->free_slots.pop_back();
            } else {
                idx = static_cast<uint32_t>(s->arena.size());
                s->arena.emplace_back();
            }
            Node& node = s->arena[idx];
            node.key = dk.key;
            node.depth = depths[i];
            node.value = values[i];
            node.ub = ubs[i];
            node.score = scores[i];
            node.path_vals.assign(path_vals + i * n, path_vals + (i + 1) * n);
            node.path_set.assign(path_set + i * n, path_set + (i + 1) * n);
            node.stamp = stamp;
            s->live.emplace(std::move(dk), idx);
            s->heap.push({node.ub, node.value, node.score, stamp, idx});
        }
    }
}

// Pops up to max_count live nodes in best-first order, skipping nodes with
// ub <= best_lb (those are discarded, like sequential.rs:337-339 but the
// caller still learns the popped ubs via out_ubs for bound tracking).
// Returns the number of nodes written.
int fringe_pop_batch(void* h, int max_count, int32_t best_lb, int32_t* keys,
                     int32_t* depths, int32_t* values, int32_t* ubs,
                     int32_t* path_vals, uint8_t* path_set,
                     long long* popped_total) {
    auto* s = static_cast<Solver*>(h);
    const int K = s->key_cols, n = s->n_vars;
    int out = 0;
    long long popped = 0;
    while (out < max_count && !s->heap.empty()) {
        HeapEntry e = s->heap.top();
        s->heap.pop();
        Node& node = s->arena[e.idx];
        if (node.stamp != e.stamp) continue;  // stale entry
        // live pop: invalidate the slot and recycle it
        s->live.erase(DepthKey{node.depth, node.key});
        node.stamp = 0;
        s->free_slots.push_back(e.idx);
        ++popped;
        if (node.ub <= best_lb) continue;  // prune
        std::memcpy(keys + out * K, node.key.data(), K * 4);
        depths[out] = node.depth;
        values[out] = node.value;
        ubs[out] = node.ub;
        std::memcpy(path_vals + out * n, node.path_vals.data(), n * 4);
        std::memcpy(path_set + out * n, node.path_set.data(), n);
        ++out;
    }
    if (popped_total) *popped_total = popped;
    return out;
}

int fringe_len(void* h) {
    return static_cast<int>(static_cast<Solver*>(h)->live.size());
}

void fringe_clear(void* h) {
    auto* s = static_cast<Solver*>(h);
    s->live.clear();
    s->heap = {};
    s->arena.clear();
    s->free_slots.clear();
}

// ----------------------------------------------------------------- cache
void cache_update_batch(void* h, int count, const int32_t* depths,
                        const int32_t* keys, const int32_t* values,
                        const uint8_t* explored) {
    auto* s = static_cast<Solver*>(h);
    const int K = s->key_cols;
    for (int i = 0; i < count; ++i) {
        std::vector<int32_t> key(keys + i * K, keys + (i + 1) * K);
        auto& layer = s->cache[depths[i]];
        auto it = layer.find(key);
        Threshold nt{values[i], explored[i]};
        if (it == layer.end()) {
            layer.emplace(std::move(key), nt);
        } else {
            // monotone max by (value, explored) (cache/simple.rs:62-66)
            Threshold& cur = it->second;
            if (nt.value > cur.value ||
                (nt.value == cur.value && nt.explored > cur.explored)) {
                cur = nt;
            }
        }
    }
}

// must_explore rule (abstraction/cache.rs:32-39); out[i] = 1 if explore
void cache_must_explore_batch(void* h, int count, const int32_t* depths,
                              const int32_t* keys, const int32_t* values,
                              uint8_t* out) {
    auto* s = static_cast<Solver*>(h);
    const int K = s->key_cols;
    for (int i = 0; i < count; ++i) {
        std::vector<int32_t> key(keys + i * K, keys + (i + 1) * K);
        auto& layer = s->cache[depths[i]];
        auto it = layer.find(key);
        if (it == layer.end()) {
            out[i] = 1;
        } else {
            const Threshold& t = it->second;
            out[i] = (values[i] > t.value ||
                      (values[i] == t.value && !t.explored))
                         ? 1
                         : 0;
        }
    }
}

void cache_clear_layer(void* h, int depth) {
    static_cast<Solver*>(h)->cache[depth].clear();
}

void cache_clear(void* h) {
    for (auto& l : static_cast<Solver*>(h)->cache) l.clear();
}

}  // extern "C"
