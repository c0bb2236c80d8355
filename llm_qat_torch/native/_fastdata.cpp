// Fast data-pipeline primitives for llm_qat_torch (CPython extension; a copy
// of llm_qat_tpu/native/_fastdata.cpp).
//
// The reference delegates all native work to torch/HF (SURVEY.md §2.2); its
// data path reads jsonl line-by-line in Python (utils/datautils.py:31-54)
// and the synthesis resume logic counts lines (generate_data.py:25-32).
// Both are O(corpus) host work on the ~100k x 2048-token synthesized
// corpus, so they live here as native code with Python fallbacks in
// data/dataset.py.
//
//   read_jsonl_texts(path, max_lines=-1) -> list[str]
//       Extracts the "text" field of every jsonl line (single-key objects
//       written by json.dumps), including full escape handling
//       (\" \\ \/ \b \f \n \r \t \uXXXX + surrogate pairs).
//   count_lines(path) -> int
//       Newline count (synthesis resume bookkeeping).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Append the UTF-8 encoding of a code point.
void append_utf8(std::string& out, unsigned int cp) {
    if (cp < 0x80) {
        out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
        out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
        out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
}

int hex_val(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

// Parse a JSON string starting just after the opening quote; returns true
// and sets `end` to the char after the closing quote.
bool parse_json_string(const char* p, const char* limit, std::string& out,
                       const char** end) {
    out.clear();
    while (p < limit) {
        // bulk-copy the run of ordinary bytes up to the next quote/escape
        const char* run = p;
        while (run < limit && *run != '"' && *run != '\\') ++run;
        out.append(p, static_cast<size_t>(run - p));
        p = run;
        if (p >= limit) break;
        unsigned char c = static_cast<unsigned char>(*p);
        if (c == '"') {
            *end = p + 1;
            return true;
        }
        if (c == '\\') {
            if (p + 1 >= limit) return false;
            char e = p[1];
            p += 2;
            switch (e) {
                case '"': out.push_back('"'); break;
                case '\\': out.push_back('\\'); break;
                case '/': out.push_back('/'); break;
                case 'b': out.push_back('\b'); break;
                case 'f': out.push_back('\f'); break;
                case 'n': out.push_back('\n'); break;
                case 'r': out.push_back('\r'); break;
                case 't': out.push_back('\t'); break;
                case 'u': {
                    if (p + 4 > limit) return false;
                    int h0 = hex_val(p[0]), h1 = hex_val(p[1]),
                        h2 = hex_val(p[2]), h3 = hex_val(p[3]);
                    if ((h0 | h1 | h2 | h3) < 0) return false;
                    unsigned int cp = (h0 << 12) | (h1 << 8) | (h2 << 4) | h3;
                    p += 4;
                    if (cp >= 0xD800 && cp <= 0xDBFF && p + 6 <= limit &&
                        p[0] == '\\' && p[1] == 'u') {
                        int g0 = hex_val(p[2]), g1 = hex_val(p[3]),
                            g2 = hex_val(p[4]), g3 = hex_val(p[5]);
                        if ((g0 | g1 | g2 | g3) >= 0) {
                            unsigned int lo =
                                (g0 << 12) | (g1 << 8) | (g2 << 4) | g3;
                            if (lo >= 0xDC00 && lo <= 0xDFFF) {
                                cp = 0x10000 + ((cp - 0xD800) << 10) +
                                     (lo - 0xDC00);
                                p += 6;
                            }
                        }
                    }
                    append_utf8(out, cp);
                    break;
                }
                default:
                    return false;
            }
            continue;
        }
    }
    return false;
}

// Find `"text"` key on the line and return its string value.
bool extract_text_field(const char* line, size_t len, std::string& out) {
    static const char kKey[] = "\"text\"";
    const char* limit = line + len;
    const char* p = static_cast<const char*>(
        memmem(line, len, kKey, sizeof(kKey) - 1));
    while (p != nullptr) {
        const char* q = p + sizeof(kKey) - 1;
        while (q < limit && (*q == ' ' || *q == '\t')) ++q;
        if (q < limit && *q == ':') {
            ++q;
            while (q < limit && (*q == ' ' || *q == '\t')) ++q;
            if (q < limit && *q == '"') {
                const char* end = nullptr;
                if (parse_json_string(q + 1, limit, out, &end)) return true;
                return false;
            }
        }
        p = static_cast<const char*>(
            memmem(p + 1, static_cast<size_t>(limit - (p + 1)), kKey,
                   sizeof(kKey) - 1));
    }
    return false;
}

PyObject* py_read_jsonl_texts(PyObject*, PyObject* args) {
    const char* path;
    Py_ssize_t max_lines = -1;
    if (!PyArg_ParseTuple(args, "s|n", &path, &max_lines)) return nullptr;

    FILE* f = fopen(path, "rb");
    if (f == nullptr) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }

    PyObject* result = PyList_New(0);
    if (result == nullptr) {
        fclose(f);
        return nullptr;
    }

    char* line = nullptr;
    size_t cap = 0;
    ssize_t n;
    std::string text;
    Py_ssize_t count = 0;
    while ((n = getline(&line, &cap, f)) != -1) {
        if (max_lines >= 0 && count >= max_lines) break;
        // skip blank lines like the Python reader
        ssize_t i = 0;
        while (i < n && (line[i] == ' ' || line[i] == '\n' || line[i] == '\r' ||
                         line[i] == '\t'))
            ++i;
        if (i == n) continue;
        ++count;
        if (!extract_text_field(line, static_cast<size_t>(n), text)) {
            free(line);
            fclose(f);
            Py_DECREF(result);
            PyErr_Format(PyExc_ValueError,
                         "line %zd of %s has no \"text\" string field",
                         count, path);
            return nullptr;
        }
        PyObject* s = PyUnicode_DecodeUTF8(text.data(),
                                           static_cast<Py_ssize_t>(text.size()),
                                           "replace");
        if (s == nullptr || PyList_Append(result, s) < 0) {
            Py_XDECREF(s);
            free(line);
            fclose(f);
            Py_DECREF(result);
            return nullptr;
        }
        Py_DECREF(s);
    }
    free(line);
    fclose(f);
    return result;
}

PyObject* py_count_lines(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    FILE* f = fopen(path, "rb");
    if (f == nullptr) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    long long lines = 0;
    std::vector<char> buf(1 << 20);
    size_t got;
    Py_BEGIN_ALLOW_THREADS
    while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
        for (size_t i = 0; i < got; ++i)
            if (buf[i] == '\n') ++lines;
    }
    Py_END_ALLOW_THREADS
    fclose(f);
    return PyLong_FromLongLong(lines);
}

PyMethodDef kMethods[] = {
    {"read_jsonl_texts", py_read_jsonl_texts, METH_VARARGS,
     "read_jsonl_texts(path, max_lines=-1) -> list[str]"},
    {"count_lines", py_count_lines, METH_VARARGS,
     "count_lines(path) -> int"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fastdata",
    "Native jsonl data-pipeline primitives", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastdata(void) { return PyModule_Create(&kModule); }
