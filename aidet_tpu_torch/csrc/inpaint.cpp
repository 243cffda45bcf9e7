// Telea's fast-marching inpaint of the port's host library, in OpenCV's
// arithmetic (imgproc/src/inpaint.cpp, `cv::inpaint(src, mask, dst,
// radius, INPAINT_TELEA)`), for the InstaBoost stage of the data layer.
//
// The hole's pixels are filled in the order of their distance to its
// border, each from the known pixels within `radius`, weighted by
// direction, distance and level-set distance (Telea 2004).  As OpenCV:
// a 1-pixel frame around the image; the border band and the hole's
// outside distances come from fast marching over a sorted list (the
// CvPriorityQueueFloat: ties leave in the order they came); the
// outside distances are negated; the image gradient at a known pixel
// is its central difference scaled by 2 (a one-sided one beside the
// hole), read one row or column inward at the image's first and last
// rows and columns, as OpenCV reads it; the result of each channel is
// (float) Ia / s + (Jx + Jy) / |J| + 0.5, rounded to nearest even and
// saturated to [0, 255].
//
// C interface (ctypes):
//   aidet_inpaint_telea(img, mask, out, h, w, channels, radius)
// img, out: h*w*channels uint8 (out may not alias img); mask: h*w uint8,
// non-zero where to inpaint.  Returns 0, or -1 for bad arguments.

#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

enum : uint8_t { KNOWN = 0, BAND = 1, INSIDE = 2, CHANGE = 3 };

struct Elem {
  float T;
  int i, j;
  Elem* prev;
  Elem* next;
};

// OpenCV's CvPriorityQueueFloat: a doubly linked list sorted by T, the
// used elements between head and `empty`, the free ones after it
class SortedList {
 public:
  bool init(const std::vector<uint8_t>& f) {
    int num = 0;
    for (uint8_t v : f) num += v != 0;
    if (num <= 0) return false;
    mem_.resize(num + 2);
    Elem* m = mem_.data();
    head_ = m;
    head_->i = head_->j = -1;
    head_->prev = nullptr;
    head_->next = m + 1;
    head_->T = -FLT_MAX;
    empty_ = m + 1;
    int i;
    for (i = 1; i <= num; ++i) {
      m[i].prev = m + i - 1;
      m[i].next = m + i + 1;
      m[i].i = -1;
      m[i].T = FLT_MAX;
    }
    tail_ = m + i;
    tail_->i = tail_->j = -1;
    tail_->prev = m + i - 1;
    tail_->next = nullptr;
    tail_->T = FLT_MAX;
    return true;
  }
  void add(const std::vector<uint8_t>& f, int cols) {
    for (size_t k = 0; k < f.size(); ++k)
      if (f[k]) push((int)(k / cols), (int)(k % cols), 0.f);
  }
  bool push(int i, int j, float T) {
    Elem *tmp = empty_, *add = empty_;
    if (empty_ == tail_) return false;
    while (tmp->prev->T > T) tmp = tmp->prev;
    if (tmp != empty_) {
      add->prev->next = add->next;
      add->next->prev = add->prev;
      empty_ = add->next;
      add->prev = tmp->prev;
      add->next = tmp;
      add->prev->next = add;
      add->next->prev = add;
    } else {
      empty_ = empty_->next;
    }
    add->i = i;
    add->j = j;
    add->T = T;
    return true;
  }
  bool pop(int* i, int* j) {
    Elem* tmp = head_->next;
    if (empty_ == tmp) return false;
    *i = tmp->i;
    *j = tmp->j;
    tmp->prev->next = tmp->next;
    tmp->next->prev = tmp->prev;
    tmp->prev = empty_->prev;
    tmp->next = empty_;
    tmp->prev->next = tmp;
    tmp->next->prev = tmp;
    empty_ = tmp;
    return true;
  }

 private:
  std::vector<Elem> mem_;
  Elem *empty_ = nullptr, *head_ = nullptr, *tail_ = nullptr;
};

float solve(int i1, int j1, int i2, int j2, const std::vector<uint8_t>& f,
            const std::vector<float>& t, int cols) {
  double a11 = t[(size_t)i1 * cols + j1];
  double a22 = t[(size_t)i2 * cols + j2];
  double m12 = a11 < a22 ? a11 : a22;
  double sol;
  bool in1 = f[(size_t)i1 * cols + j1] == INSIDE;
  bool in2 = f[(size_t)i2 * cols + j2] == INSIDE;
  if (!in1) {
    if (!in2) {
      if (fabs(a11 - a22) >= 1.0)
        sol = 1 + m12;
      else
        sol = (a11 + a22 + sqrt((double)(2 - (a11 - a22) * (a11 - a22)))) *
              0.5;
    } else {
      sol = 1 + a11;
    }
  } else if (!in2) {
    sol = 1 + a22;
  } else {
    sol = 1 + m12;
  }
  return (float)sol;
}

inline float min4(float a, float b, float c, float d) {
  a = a < b ? a : b;
  c = c < d ? c : d;
  return a < c ? a : c;
}

float march_distance(int i, int j, const std::vector<uint8_t>& f,
                     const std::vector<float>& t, int cols) {
  return min4(solve(i - 1, j, i, j - 1, f, t, cols),
              solve(i + 1, j, i, j - 1, f, t, cols),
              solve(i - 1, j, i, j + 1, f, t, cols),
              solve(i + 1, j, i, j + 1, f, t, cols));
}

const int kDi[4] = {-1, 0, 1, 0};
const int kDj[4] = {0, -1, 0, 1};

// icvCalcFMM with negate: the distances outside the hole, negated
void outside_distances(std::vector<uint8_t>& f, std::vector<float>& t,
                       SortedList& heap, int rows, int cols) {
  int ii, jj;
  while (heap.pop(&ii, &jj)) {
    f[(size_t)ii * cols + jj] = CHANGE;
    for (int q = 0; q < 4; ++q) {
      int i = ii + kDi[q], j = jj + kDj[q];
      if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) continue;
      if (f[(size_t)i * cols + j] == INSIDE) {
        float dist = march_distance(i, j, f, t, cols);
        t[(size_t)i * cols + j] = dist;
        f[(size_t)i * cols + j] = BAND;
        heap.push(i, j, dist);
      }
    }
  }
  for (size_t k = 0; k < f.size(); ++k) {
    if (f[k] == CHANGE) {
      f[k] = KNOWN;
      t[k] = -t[k];
    }
  }
}

// OpenCV's dilate of a mask by a (2r+1)^2 square or a 3x3 cross, its
// border ignored; only the box around the mask's non-zero pixels is
// visited
void dilate(const std::vector<uint8_t>& src, std::vector<uint8_t>& dst,
            int rows, int cols, int r, bool cross) {
  dst.assign(src.size(), 0);
  int y0 = rows, y1 = -1, x0 = cols, x1 = -1;
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j)
      if (src[(size_t)i * cols + j]) {
        y0 = i < y0 ? i : y0;
        y1 = i > y1 ? i : y1;
        x0 = j < x0 ? j : x0;
        x1 = j > x1 ? j : x1;
      }
  y0 = y0 - r > 0 ? y0 - r : 0;
  x0 = x0 - r > 0 ? x0 - r : 0;
  y1 = y1 + r < rows - 1 ? y1 + r : rows - 1;
  x1 = x1 + r < cols - 1 ? x1 + r : cols - 1;
  for (int i = y0; i <= y1; ++i) {
    for (int j = x0; j <= x1; ++j) {
      uint8_t m = 0;
      for (int di = -r; di <= r; ++di) {
        int y = i + di;
        if (y < 0 || y >= rows) continue;
        for (int dj = -r; dj <= r; ++dj) {
          if (cross && di && dj) continue;
          int x = j + dj;
          if (x < 0 || x >= cols) continue;
          uint8_t v = src[(size_t)y * cols + x];
          m = v > m ? v : m;
        }
      }
      dst[(size_t)i * cols + j] = m;
    }
  }
}

void zero_border(std::vector<uint8_t>& a, int rows, int cols) {
  for (int j = 0; j < cols; ++j) a[j] = a[(size_t)(rows - 1) * cols + j] = 0;
  for (int i = 1; i < rows - 1; ++i)
    a[(size_t)i * cols] = a[(size_t)i * cols + cols - 1] = 0;
}

inline uint8_t saturate(float v) {
  long r = lrintf(v);
  return (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
}

void telea(std::vector<uint8_t>& f, std::vector<float>& t, uint8_t* out,
           int rows, int cols, int ch, int range, SortedList& heap) {
  const int w = cols - 2;
  auto F = [&](int i, int j) -> uint8_t { return f[(size_t)i * cols + j]; };
  auto T = [&](int i, int j) -> float { return t[(size_t)i * cols + j]; };
  auto O = [&](int y, int x, int c) -> float {
    return (float)out[((size_t)y * w + x) * ch + c];
  };
  std::vector<float> Jx(ch), Jy(ch), Ia(ch), s(ch);
  int ii, jj;
  while (heap.pop(&ii, &jj)) {
    f[(size_t)ii * cols + jj] = KNOWN;
    for (int q = 0; q < 4; ++q) {
      int i = ii + kDi[q], j = jj + kDj[q];
      if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) continue;
      if (F(i, j) != INSIDE) continue;
      float dist = march_distance(i, j, f, t, cols);
      t[(size_t)i * cols + j] = dist;
      float gx, gy;
      if (F(i, j + 1) != INSIDE) {
        gx = F(i, j - 1) != INSIDE ? (float)(T(i, j + 1) - T(i, j - 1)) * 0.5f
                                   : (float)(T(i, j + 1) - T(i, j));
      } else {
        gx = F(i, j - 1) != INSIDE ? (float)(T(i, j) - T(i, j - 1)) : 0.f;
      }
      if (F(i + 1, j) != INSIDE) {
        gy = F(i - 1, j) != INSIDE ? (float)(T(i + 1, j) - T(i - 1, j)) * 0.5f
                                   : (float)(T(i + 1, j) - T(i, j));
      } else {
        gy = F(i - 1, j) != INSIDE ? (float)(T(i, j) - T(i - 1, j)) : 0.f;
      }
      for (int c = 0; c < ch; ++c) {
        Jx[c] = Jy[c] = Ia[c] = 0.f;
        s[c] = 1.0e-20f;
      }
      for (int k = i - range; k <= i + range; ++k) {
        int km = k - 1 + (k == 1), kp = k - 1 - (k == rows - 2);
        for (int l = j - range; l <= j + range; ++l) {
          int lm = l - 1 + (l == 1), lp = l - 1 - (l == cols - 2);
          if (!(k > 0 && l > 0 && k < rows - 1 && l < cols - 1)) continue;
          if (F(k, l) == INSIDE ||
              (l - j) * (l - j) + (k - i) * (k - i) > range * range)
            continue;
          float ry = (float)(i - k), rx = (float)(j - l);
          float len2 = rx * rx + ry * ry;
          float dst = (float)(1. / (len2 * sqrt((double)len2)));
          float dt = T(k, l) - T(i, j);   // float, then 1 + |dt| in double
          float lev = (float)(1. / (1 + fabs((double)dt)));
          float dir = rx * gx + ry * gy;
          if (fabs(dir) <= 0.01) dir = 0.000001f;
          float wgt = (float)fabs(dst * lev * dir);
          for (int c = 0; c < ch; ++c) {
            float gix, giy;
            if (F(k, l + 1) != INSIDE) {
              gix = F(k, l - 1) != INSIDE
                        ? (float)(O(km, lp + 1, c) - O(km, lm - 1, c)) * 2.0f
                        : (float)(O(km, lp + 1, c) - O(km, lm, c));
            } else {
              gix = F(k, l - 1) != INSIDE
                        ? (float)(O(km, lp, c) - O(km, lm - 1, c))
                        : 0.f;
            }
            if (F(k + 1, l) != INSIDE) {
              giy = F(k - 1, l) != INSIDE
                        ? (float)(O(kp + 1, lm, c) - O(km - 1, lm, c)) * 2.0f
                        : (float)(O(kp + 1, lm, c) - O(km, lm, c));
            } else {
              giy = F(k - 1, l) != INSIDE
                        ? (float)(O(kp, lm, c) - O(km - 1, lm, c))
                        : 0.f;
            }
            Ia[c] += wgt * O(k - 1, l - 1, c);
            Jx[c] -= wgt * (gix * rx);
            Jy[c] -= wgt * (giy * ry);
            s[c] += wgt;
          }
        }
      }
      for (int c = 0; c < ch; ++c) {
        float sat = (float)(Ia[c] / s[c] +
                            (Jx[c] + Jy[c]) /
                                (sqrtf(Jx[c] * Jx[c] + Jy[c] * Jy[c]) +
                                 1.0e-20f) +
                            0.5f);
        out[((size_t)(i - 1) * w + (j - 1)) * ch + c] = saturate(sat);
      }
      f[(size_t)i * cols + j] = BAND;
      heap.push(i, j, dist);
    }
  }
}

}  // namespace

extern "C" int aidet_inpaint_telea(const uint8_t* img, const uint8_t* hole,
                                   uint8_t* out, int h, int w, int channels,
                                   double radius) {
  if (h <= 0 || w <= 0 || channels < 1 || channels > 4) return -1;
  memcpy(out, img, (size_t)h * w * channels);
  int range = (int)lrint(radius);
  range = range < 1 ? 1 : range > 100 ? 100 : range;
  const int rows = h + 2, cols = w + 2;
  const size_t n = (size_t)rows * cols;
  std::vector<uint8_t> mask(n, KNOWN);
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j)
      if (hole[(size_t)i * w + j]) mask[(size_t)(i + 1) * cols + j + 1] = INSIDE;
  zero_border(mask, rows, cols);
  std::vector<uint8_t> f(n, KNOWN), band, outer;
  std::vector<float> t(n, 1.0e6f);
  dilate(mask, band, rows, cols, 1, true);
  SortedList heap;
  if (!heap.init(band)) return 0;             // nothing to inpaint
  for (size_t k = 0; k < n; ++k) band[k] = band[k] - mask[k];
  zero_border(band, rows, cols);
  heap.add(band, cols);
  for (size_t k = 0; k < n; ++k) {
    if (band[k]) {
      f[k] = BAND;
      t[k] = 0.f;
    }
    if (mask[k]) f[k] = INSIDE;
  }
  dilate(mask, outer, rows, cols, range, false);
  for (size_t k = 0; k < n; ++k) outer[k] = outer[k] - mask[k];
  SortedList out_heap;
  if (!out_heap.init(outer)) return 0;
  out_heap.add(band, cols);
  for (size_t k = 0; k < n; ++k)
    outer[k] = outer[k] > band[k] ? outer[k] - band[k] : 0;
  zero_border(outer, rows, cols);
  outside_distances(outer, t, out_heap, rows, cols);
  telea(mask, t, out, rows, cols, channels, range, heap);
  return 0;
}
