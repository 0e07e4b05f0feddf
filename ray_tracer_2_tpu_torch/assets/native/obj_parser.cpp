// Native Wavefront OBJ tokenizer (ctypes; see __init__.py loader): a copy
// of ray_tracer_2_tpu/assets/native/obj_parser.cpp.
//
// The reference gets native OBJ parsing from tobj (asset.rs:110-118); this
// is the equivalent runtime component here. It reproduces the SEMANTICS of
// assets/obj.py::load_obj's parse phase exactly — '#' comments, whitespace
// tokens, fan triangulation, negative indices resolved against the stream
// length at parse time, groups keyed by (o/g name, usemtl) in first-seen
// order — and hands flat arrays back to Python, which runs the shared
// de-index/normal-generation assembly (obj.py). MTL parsing stays in
// Python (small files).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Parsed {
    std::vector<float> v, vt, vn;
    // per triangle: 9 int64 (3 corners x [vi, ti, ni]), already 0-based,
    // -1 = absent
    std::vector<long long> tris;
    std::vector<int> tri_group;
    std::string group_blob;   // "name\x1fmtl\x1e" per group ('\x1f' sep);
                              // mtl == "\x1b" means None
    std::string mtllibs;      // referenced mtllib strings, '\n'-separated
    int n_groups = 0;
    bool ok = false;
};

bool parse_corner(const char* tok, long long nv, long long nt, long long nn,
                  long long out[3]) {
    // 'v', 'v/t', 'v//n', 'v/t/n' (1-based; negative = relative)
    char* end;
    long long vi = strtoll(tok, &end, 10);
    if (end == tok) return false;
    out[0] = vi > 0 ? vi - 1 : nv + vi;
    out[1] = -1;
    out[2] = -1;
    if (*end == '/') {
        const char* p = end + 1;
        if (*p != '/' && *p != '\0') {
            long long ti = strtoll(p, &end, 10);
            if (end != p) out[1] = ti > 0 ? ti - 1 : nt + ti;
            p = end;
        }
        if (*p == '/') {
            ++p;
            long long ni = strtoll(p, &end, 10);
            if (end != p) out[2] = ni > 0 ? ni - 1 : nn + ni;
        }
    }
    return true;
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
    auto* P = new Parsed();
    FILE* f = fopen(path, "rb");
    if (!f) return P;

    std::string cur_obj = "";
    std::string cur_mtl = "\x1b";  // sentinel: None
    std::unordered_map<std::string, int> group_ids;
    std::vector<std::string> group_keys;

    auto group_id = [&]() -> int {
        std::string key = cur_obj + '\x1f' + cur_mtl;
        auto it = group_ids.find(key);
        if (it != group_ids.end()) return it->second;
        int gid = P->n_groups++;
        group_ids.emplace(key, gid);
        P->group_blob += key;
        P->group_blob += '\x1e';
        return gid;
    };

    char line[65536];
    std::vector<char*> parts;
    std::vector<long long> corners;
    while (fgets(line, sizeof line, f)) {
        // strip comment
        if (char* h = strchr(line, '#')) *h = '\0';
        // tokenize on whitespace
        parts.clear();
        for (char* tok = strtok(line, " \t\r\n"); tok;
             tok = strtok(nullptr, " \t\r\n"))
            parts.push_back(tok);
        if (parts.empty()) continue;
        const char* key = parts[0];

        if (!strcmp(key, "v") && parts.size() >= 4) {
            for (int i = 1; i <= 3; ++i)
                P->v.push_back(strtof(parts[i], nullptr));
        } else if (!strcmp(key, "vt") && parts.size() >= 3) {
            for (int i = 1; i <= 2; ++i)
                P->vt.push_back(strtof(parts[i], nullptr));
        } else if (!strcmp(key, "vn") && parts.size() >= 4) {
            for (int i = 1; i <= 3; ++i)
                P->vn.push_back(strtof(parts[i], nullptr));
        } else if (!strcmp(key, "f")) {
            long long nv = (long long)P->v.size() / 3;
            long long nt = (long long)P->vt.size() / 2;
            long long nn = (long long)P->vn.size() / 3;
            corners.clear();
            for (size_t i = 1; i < parts.size(); ++i) {
                long long c[3];
                if (!parse_corner(parts[i], nv, nt, nn, c)) continue;
                corners.insert(corners.end(), c, c + 3);
            }
            size_t nc = corners.size() / 3;
            if (nc < 3) continue;
            int gid = group_id();
            for (size_t k = 1; k + 1 < nc; ++k) {  // fan triangulation
                const long long* c0 = &corners[0];
                const long long* ck = &corners[3 * k];
                const long long* c1 = &corners[3 * (k + 1)];
                P->tris.insert(P->tris.end(), c0, c0 + 3);
                P->tris.insert(P->tris.end(), ck, ck + 3);
                P->tris.insert(P->tris.end(), c1, c1 + 3);
                P->tri_group.push_back(gid);
            }
        } else if ((!strcmp(key, "o") || !strcmp(key, "g"))) {
            cur_obj.clear();
            for (size_t i = 1; i < parts.size(); ++i) {
                if (i > 1) cur_obj += ' ';
                cur_obj += parts[i];
            }
        } else if (!strcmp(key, "usemtl")) {
            cur_mtl = parts.size() > 1 ? std::string(parts[1])
                                       : std::string("\x1b");
        } else if (!strcmp(key, "mtllib") && parts.size() > 1) {
            std::string name;
            for (size_t i = 1; i < parts.size(); ++i) {
                if (i > 1) name += ' ';
                name += parts[i];
            }
            P->mtllibs += name;
            P->mtllibs += '\n';
        }
    }
    fclose(f);
    P->ok = true;
    return P;
}

int obj_ok(void* h) { return ((Parsed*)h)->ok ? 1 : 0; }
long long obj_nv(void* h) { return (long long)((Parsed*)h)->v.size() / 3; }
long long obj_nt(void* h) { return (long long)((Parsed*)h)->vt.size() / 2; }
long long obj_nn(void* h) { return (long long)((Parsed*)h)->vn.size() / 3; }
long long obj_ntris(void* h) {
    return (long long)((Parsed*)h)->tri_group.size();
}
int obj_ngroups(void* h) { return ((Parsed*)h)->n_groups; }
const float* obj_v(void* h) { return ((Parsed*)h)->v.data(); }
const float* obj_vt(void* h) { return ((Parsed*)h)->vt.data(); }
const float* obj_vn(void* h) { return ((Parsed*)h)->vn.data(); }
const long long* obj_tris(void* h) { return ((Parsed*)h)->tris.data(); }
const int* obj_tri_group(void* h) { return ((Parsed*)h)->tri_group.data(); }
const char* obj_groups(void* h) { return ((Parsed*)h)->group_blob.c_str(); }
const char* obj_mtllibs(void* h) { return ((Parsed*)h)->mtllibs.c_str(); }
void obj_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
