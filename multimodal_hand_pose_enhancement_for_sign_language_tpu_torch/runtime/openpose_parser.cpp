// Fast OpenPose-frame JSON scanner.
//
// The dataset-ingestion hot path on the host is parsing millions of small
// per-frame OpenPose JSON files (reference: utils/utils.py:151-170 via
// Python's json module inside a ProcessPoolExecutor).  These files have a
// fixed narrow schema, so a specialized scanner that locates the three
// keypoint arrays and strtod's the floats is an order of magnitude faster
// than a general JSON parser — and needs no extra threads or processes.
//
// Built by runtime/native.py at first use: g++ -O3 -shared -fPIC.

#include <cstdlib>
#include <cstring>

namespace {

// Parse up to `max_vals` comma-separated floats following the first '['
// after `key` in buf[0, len).  Returns the number parsed, or -1 if the
// key is missing.
int parse_key_array(const char* buf, long len, const char* key,
                    float* out, int max_vals) {
  const char* end = buf + len;
  const char* p = static_cast<const char*>(
      memmem(buf, static_cast<size_t>(len), key, strlen(key)));
  if (p == nullptr) return -1;
  p += strlen(key);
  while (p < end && *p != '[') ++p;
  if (p >= end) return -1;
  ++p;
  int n = 0;
  while (p < end && n < max_vals) {
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) {  // no progress: separator or ']'
      if (*p == ']') break;
      ++p;
      continue;
    }
    out[n++] = static_cast<float>(v);
    p = next;
    while (p < end && (*p == ',' || *p == ' ' || *p == '\n' || *p == '\r' ||
                       *p == '\t'))
      ++p;
    if (p < end && *p == ']') break;
  }
  return n;
}

}  // namespace

extern "C" {

// Parses one OpenPose frame: body 25x3 floats, right/left hand 21x3 each.
// Returns 0 on success, negative error code otherwise.
int parse_openpose_frame(const char* buf, long len, float* body /*75*/,
                         float* hand_right /*63*/, float* hand_left /*63*/) {
  if (parse_key_array(buf, len, "\"pose_keypoints_2d\"", body, 75) != 75)
    return -1;
  if (parse_key_array(buf, len, "\"hand_right_keypoints_2d\"", hand_right,
                      63) != 63)
    return -2;
  if (parse_key_array(buf, len, "\"hand_left_keypoints_2d\"", hand_left, 63) !=
      63)
    return -3;
  return 0;
}

}  // extern "C"
