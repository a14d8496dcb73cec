/* Native DICOM codec for sift3d_tpu.
 *
 * A self-contained C++17 implementation of the DICOM behaviors of the
 * reference's DCMTK wrapper (reference imutil/dicom.cpp), written
 * from scratch (no DCMTK):
 *
 *  - Part-10 parsing: preamble + DICM magic, explicit-VR-LE file meta
 *    group, dataset in Implicit or Explicit VR Little Endian. Compressed
 *    transfer syntaxes are rejected with a clear error (the reference
 *    supports JPEG via DCMTK codecs; this codec targets the uncompressed
 *    formats the reference itself writes).
 *  - Metadata model mirroring the reference Dicom class
 *    (dicom.cpp:155-310): SOP class/series UIDs, ImagePositionPatient x
 *    ImageOrientationPatient normal -> slice sort coordinate, dominant
 *    axes + signs (supports e.g. y-z-plane mammograms), pixel spacing +
 *    slice thickness -> units.
 *  - Single-file read incl. multi-frame, 8/16/32-bit signed/unsigned,
 *    axis-flip copy for negative orientation signs, modality rescale
 *    slope/intercept (what DCMTK's DiMonoPixel inter-data applies).
 *  - Directory read: collect *.dcm (ignoring DSOs), sort by coordinate,
 *    verify same series, even spacing (tol 5e-2), no duplicates
 *    (dicom.cpp:1152-1366).
 *  - Write single 8-bit CT-class file with the reference's exact metadata
 *    (dicom.cpp:1484-1775) and directory write slice-per-file with
 *    zero-padded names (dicom.cpp:1778-1856).
 *
 * C ABI (ctypes-friendly); error codes mirror imutil.h:20-27.
 */

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <functional>
#include <random>
#include <string>
#include <sys/stat.h>
#include <vector>

namespace {

// Error codes (keep in sync with the Python binding)
enum {
    S3D_SUCCESS = 0,
    S3D_FAILURE = -1,
    S3D_FILE_DOES_NOT_EXIST = -2,
    S3D_UNSUPPORTED_FILE_TYPE = -3,
    S3D_UNEVEN_SPACING = -4,
    S3D_INCONSISTENT_AXES = -5,
    S3D_DUPLICATE_SLICES = -6,
};

const char *UID_ImplicitLE = "1.2.840.10008.1.2";
const char *UID_ExplicitLE = "1.2.840.10008.1.2.1";
// Explicit VR Big Endian (retired, but DCMTK reads it natively so
// reference-readable archives may carry it).
const char *UID_ExplicitBE = "1.2.840.10008.1.2.2";
// JPEG Lossless, Non-Hierarchical (Process 14) and its First-Order
// Prediction SV1 restriction - the syntax the reference itself writes
// through DCMTK (reference dicom.cpp:1748) and registers decoders for
// (dicom.cpp:69-73), so reference-produced directories need it.
const char *UID_JPEGLossless14 = "1.2.840.10008.1.2.4.57";
const char *UID_JPEGLosslessSV1 = "1.2.840.10008.1.2.4.70";
// Lossy DCT-based JPEG: Baseline (Process 1, 8-bit) and Extended
// (Process 2&4, 12-bit) - DCMTK registers decoders for these too
// (reference dicom.cpp:69-73).
const char *UID_JPEGBaseline = "1.2.840.10008.1.2.4.50";
const char *UID_JPEGExtended = "1.2.840.10008.1.2.4.51";
const char *UID_CTImageStorage = "1.2.840.10008.5.1.4.1.1.2";
const char *UID_DSO = "1.2.840.10008.5.1.4.1.1.66.4";
const char *UID_PET = "1.2.840.10008.5.1.4.1.1.128";
const char *UID_ROOT = "1.2.826.0.1.3680043.10.1221."; // generated-UID root

struct Tag {
    uint16_t group, elem;
    bool operator==(const Tag &o) const {
        return group == o.group && elem == o.elem;
    }
    bool operator<(const Tag &o) const {
        return group != o.group ? group < o.group : elem < o.elem;
    }
};

// Tags we consume
const Tag kTransferSyntax   {0x0002, 0x0010};
const Tag kSOPClassUID      {0x0008, 0x0016};
const Tag kSOPInstanceUID   {0x0008, 0x0018};
const Tag kSeriesUID        {0x0020, 0x000E};
const Tag kImagePosition    {0x0020, 0x0032};
const Tag kImageOrientation {0x0020, 0x0037};
const Tag kSliceThickness   {0x0018, 0x0050};
const Tag kSamplesPerPixel  {0x0028, 0x0002};
const Tag kPhotometric      {0x0028, 0x0004};
const Tag kPlanarConfig     {0x0028, 0x0006};
const Tag kNumberOfFrames   {0x0028, 0x0008};
const Tag kRows             {0x0028, 0x0010};
const Tag kColumns          {0x0028, 0x0011};
const Tag kPixelSpacing     {0x0028, 0x0030};
const Tag kBitsAllocated    {0x0028, 0x0100};
const Tag kPixelRep         {0x0028, 0x0103};
const Tag kRescaleIntercept {0x0028, 0x1052};
const Tag kRescaleSlope     {0x0028, 0x1053};
// Palette Color LUTs (PS3.3 C.7.6.3.1.5-6): per-channel descriptor
// (entries, first-mapped, bits) + entry data, red/green/blue.
const Tag kPaletteDesc[3] = {{0x0028, 0x1101}, {0x0028, 0x1102},
                             {0x0028, 0x1103}};
const Tag kPaletteData[3] = {{0x0028, 0x1201}, {0x0028, 0x1202},
                             {0x0028, 0x1203}};
const Tag kPixelData        {0x7FE0, 0x0010};
// PET SUV tags (searched into sequences, like DCMTK's searchIntoSub)
const Tag kRefSeriesSeq     {0x0008, 0x1115};
const Tag kRefSOPInstance   {0x0008, 0x1155};
const Tag kSegmentNumber    {0x0062, 0x0004};
const Tag kPatientWeight    {0x0010, 0x1010};
const Tag kRadioTotalDose   {0x0018, 0x1074};
const Tag kRadioStartTime   {0x0018, 0x1072};
const Tag kRadioHalfLife    {0x0018, 0x1075};
const Tag kAcquisitionTime  {0x0008, 0x0032};

char g_err[1024] = {0};

void set_err(const char *fmt, const char *a = "", const char *b = "") {
    snprintf(g_err, sizeof(g_err), fmt, a, b);
}

// ---------------------------------------------------------------- parsing

struct Element {
    Tag tag;
    std::string vr;           // empty for implicit
    std::vector<uint8_t> value;
};

struct Parser {
    const uint8_t *p, *end;
    bool explicit_vr = true;
    // Explicit VR Big Endian dataset (1.2.840.10008.1.2.2): tag numbers
    // and lengths are byte-swapped. The file meta group stays LE.
    bool big_endian = false;

    bool avail(size_t n) const { return (size_t)(end - p) >= n; }
    uint16_t u16() {
        uint16_t v; memcpy(&v, p, 2); p += 2;
        return big_endian ? (uint16_t)((v >> 8) | (v << 8)) : v;
    }
    uint32_t u32() {
        uint32_t v; memcpy(&v, p, 4); p += 4;
        return big_endian ? __builtin_bswap32(v) : v;
    }

    // Parse one element header; returns length (0xFFFFFFFF = undefined).
    bool header(Tag &tag, std::string &vr, uint32_t &len) {
        if (!avail(8)) return false;
        tag.group = u16();
        tag.elem = u16();
        if (tag.group == 0xFFFE) {      // item / delimiter: no VR ever
            vr.clear();
            len = u32();
            return true;
        }
        if (explicit_vr) {
            char v0 = (char)p[0], v1 = (char)p[1];
            vr.assign({v0, v1});
            p += 2;
            if (vr == "OB" || vr == "OW" || vr == "OF" || vr == "OD" ||
                vr == "OL" || vr == "SQ" || vr == "UC" || vr == "UR" ||
                vr == "UT" || vr == "UN") {
                if (!avail(6)) return false;
                p += 2;                 // reserved
                len = u32();
            } else {
                if (!avail(2)) return false;
                len = u16();
            }
        } else {
            vr.clear();
            len = u32();
        }
        return true;
    }

    // Skip a sequence with undefined length (items until FFFE,E0DD).
    bool skip_undefined_sq() {
        for (;;) {
            Tag t; std::string vr; uint32_t len;
            if (!header(t, vr, len)) return false;
            if (t.group == 0xFFFE && t.elem == 0xE0DD) return true;
            if (t.group == 0xFFFE && t.elem == 0xE000) {
                if (len == 0xFFFFFFFFu) {
                    // item with undefined length: nested elements until
                    // item delimiter FFFE,E00D
                    for (;;) {
                        Tag t2; std::string vr2; uint32_t len2;
                        if (!header(t2, vr2, len2)) return false;
                        if (t2.group == 0xFFFE && t2.elem == 0xE00D) break;
                        if (len2 == 0xFFFFFFFFu) {
                            if (!skip_undefined_sq()) return false;
                        } else {
                            if (!avail(len2)) return false;
                            p += len2;
                        }
                    }
                } else {
                    if (!avail(len)) return false;
                    p += len;
                }
            } else {
                return false;           // malformed
            }
        }
    }
};

struct DcmFile {
    std::string transfer_syntax;
    std::string sop_class, series_uid, sop_instance;
    // DSO fields: per-frame referenced instance UIDs (document order,
    // reference dicom.cpp:1104-1117) and SegmentSequence entry count.
    std::vector<std::string> ref_instance_uids;
    int n_segments = 0;
    double im_pos[3] = {0, 0, 0};
    double im_ori[6] = {1, 0, 0, 0, 1, 0};
    bool has_ori = false, has_pos = false;
    double pixel_spacing[2] = {1, 1};
    bool has_spacing = false;
    double slice_thickness = 1;
    bool has_thickness = false;
    double rescale_slope = 1, rescale_intercept = 0;
    int rows = 0, cols = 0, frames = 1, nc = 1;
    int bits_alloc = 8, pixel_rep = 0, planar = 0;
    bool big_endian = false;     // Explicit VR Big Endian pixel samples
    // PhotometricInterpretation (RGB / MONOCHROME* / PALETTE COLOR /
    // YBR_FULL[_422]); empty when absent.
    std::string photometric;
    // Palette Color LUTs: raw descriptor triples (endian-corrected) and
    // entry bytes, index 0/1/2 = R/G/B.
    uint16_t pal_desc[3][3] = {{0}};
    bool has_pal_desc[3] = {false, false, false};
    std::vector<uint8_t> pal_data[3];
    std::vector<uint8_t> pixel_data;
    // Encapsulated (compressed) pixel data: raw fragments + the Basic
    // Offset Table, decoded into pixel_data after the dataset walk.
    bool encapsulated = false;
    bool lossy_dct = false;      // SOF0/SOF1 syntax vs lossless SOF3
    std::vector<std::vector<uint8_t>> fragments;
    std::vector<uint32_t> bot;
    // PET SUV inputs (dicom.cpp:646-740)
    double weight = -1, dose = -1, half_life = -1;
    double radio_start_time = -1, acq_time = -1;
};

// TM value (HHMMSS.frac) -> seconds (reference parseTM).
bool parse_tm(const std::string &s, double *out) {
    if (s.size() < 6) return false;
    for (int i = 0; i < 6; i++)
        if (!isdigit((unsigned char)s[i])) return false;
    double hh = std::stod(s.substr(0, 2));
    double mm = std::stod(s.substr(2, 2));
    double ss = std::stod(s.substr(4));
    *out = hh * 3600.0 + mm * 60.0 + ss;
    return true;
}

std::string trim(const std::string &s) {
    size_t a = s.find_first_not_of(" \0", 0, 2);
    size_t b = s.find_last_not_of(" \0", std::string::npos, 2);
    return a == std::string::npos ? "" : s.substr(a, b - a + 1);
}

bool parse_multi_double(const std::string &s, double *out, int n) {
    size_t pos = 0;
    for (int i = 0; i < n; i++) {
        size_t next = s.find('\\', pos);
        std::string part = s.substr(pos, next == std::string::npos
                                    ? std::string::npos : next - pos);
        try {
            out[i] = std::stod(part);
        } catch (...) {
            return false;
        }
        if (next == std::string::npos && i != n - 1) return false;
        pos = next + 1;
    }
    return true;
}

// ---------------------------------------------------- JPEG lossless codec
//
// Minimal ITU T.81 lossless (SOF3) codec: single-component scans,
// predictors 1-7, point transform, restart intervals, 2-16 bit
// precision. Covers what DICOM's Process 14 / 14-SV1 transfer syntaxes
// need (PS3.5 A.4.4); the reference gets this from DCMTK's djcodecd.

struct HuffTable {
    // Canonical table per T.81 Annex C/F: mincode/maxcode/valptr by
    // code length, values indexed by decode order.
    int32_t mincode[17] = {0}, maxcode[17] = {0};
    int valptr[17] = {0};
    std::vector<uint8_t> values;
    bool present = false;

    void build(const uint8_t counts[16], const uint8_t *vals, int nvals) {
        values.assign(vals, vals + nvals);
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            code += counts[l - 1];
            k += counts[l - 1];
            maxcode[l] = code - 1;
            if (!counts[l - 1]) maxcode[l] = -1;
            code <<= 1;
        }
        present = true;
    }
};

struct BitReader {
    const uint8_t *p, *end;
    uint32_t acc = 0;
    int nbits = 0;
    bool bad = false;
    int marker = 0;      // pending marker (e.g. RSTn) hit during refill

    BitReader(const uint8_t *b, const uint8_t *e) : p(b), end(e) {}

    void refill() {
        while (nbits <= 24) {
            if (p >= end) { bad = true; return; }
            uint8_t b = *p;
            if (b == 0xFF) {
                if (p + 1 >= end) { bad = true; return; }
                uint8_t b2 = p[1];
                if (b2 == 0x00) {            // stuffed FF
                    p += 2;
                } else {                      // real marker: stop here
                    marker = 0xFF00 | b2;
                    return;
                }
            } else {
                p += 1;
            }
            acc = (acc << 8) | b;
            nbits += 8;
        }
    }

    int bits(int n) {                         // n <= 16
        if (n == 0) return 0;
        if (nbits < n) refill();
        if (nbits < n) { bad = true; return 0; }
        int v = (int)((acc >> (nbits - n)) & ((1u << n) - 1));
        nbits -= n;
        return v;
    }

    int decode(const HuffTable &t) {          // one Huffman symbol
        int code = bits(1), l = 1;
        while (l <= 16) {
            if (t.maxcode[l] >= 0 && code <= t.maxcode[l])
                return t.values[t.valptr[l] + code - t.mincode[l]];
            code = (code << 1) | bits(1);
            l++;
            if (bad) break;
        }
        bad = true;
        return 0;
    }

    void align_and_skip_rst() {               // consume a restart marker
        nbits = 0;                            // discard partial byte
        acc = 0;
        if (!marker) refill();
        if (marker >= 0xFFD0 && marker <= 0xFFD7) {
            p += 2;                           // marker bytes not yet eaten
            marker = 0;
        }
    }
};

// Diff decode: category SSSS then SSSS additional bits (T.81 F.2.2.1
// extend); category 16 means +32768 with no extra bits (lossless only).
inline int32_t jls_extend(int v, int ssss) {
    if (ssss == 0) return 0;
    if (ssss >= 16) return 32768;
    if (v < (1 << (ssss - 1))) v += -(1 << ssss) + 1;
    return v;
}

// Decode one SOF3 stream into samples[w*h]. Returns false + set_err on
// malformed / unsupported input. `precision` returns SOF3 P.
bool jls_decode(const uint8_t *buf, size_t len, int want_w, int want_h,
                std::vector<uint16_t> &samples, int *precision,
                const char *path) {
    const uint8_t *p = buf, *end = buf + len;
    auto u16be = [&](const uint8_t *q) {
        return (int)((q[0] << 8) | q[1]);
    };
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) {
        set_err("%s: fragment is not a JPEG stream", path);
        return false;
    }
    p += 2;
    HuffTable tables[4];
    int P = 0, w = 0, h = 0, ri = 0;
    int pred_sel = 1, pt = 0, tbl_id = 0;
    const uint8_t *scan = nullptr;

    while (p + 4 <= end) {
        if (p[0] != 0xFF) { p++; continue; }
        int m = p[1];
        if (m == 0xFF) { p++; continue; }
        p += 2;
        if (m == 0xD9) break;                 // EOI before SOS: malformed
        int seglen = u16be(p);
        if (p + seglen > end || seglen < 2) {
            set_err("%s: truncated JPEG segment", path);
            return false;
        }
        const uint8_t *q = p + 2, *qend = p + seglen;
        const size_t seg_avail = (size_t)(qend - q);
        if (m == 0xC3) {                      // SOF3: lossless sequential
            if (seg_avail < 9) {
                set_err("%s: truncated JPEG SOF segment", path);
                return false;
            }
            P = q[0];
            h = u16be(q + 1);
            w = u16be(q + 3);
            int nf = q[5];
            if (nf != 1) {
                set_err("%s: only single-component lossless JPEG is "
                        "supported", path);
                return false;
            }
        } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                   m != 0xCC) {
            set_err("%s: JPEG SOF%s is not lossless (only SOF3)", path,
                    std::to_string(m - 0xC0).c_str());
            return false;
        } else if (m == 0xC4) {               // DHT
            while (q + 17 <= qend) {
                int tc = q[0] >> 4, th = q[0] & 15;
                const uint8_t *counts = q + 1;
                int nv = 0;
                for (int i = 0; i < 16; i++) nv += counts[i];
                if (q + 17 + nv > qend) break;
                if (tc == 0 && th < 4)
                    tables[th].build(counts, q + 17, nv);
                q += 17 + nv;
            }
        } else if (m == 0xDD) {               // DRI
            if (seg_avail < 2) {
                set_err("%s: truncated JPEG DRI segment", path);
                return false;
            }
            ri = u16be(q);
        } else if (m == 0xDA) {               // SOS
            if (seg_avail < 6) {
                set_err("%s: truncated JPEG SOS segment", path);
                return false;
            }
            int ns = q[0];
            if (ns != 1) {
                set_err("%s: multi-component JPEG scan unsupported", path);
                return false;
            }
            tbl_id = q[2] >> 4;
            if (tbl_id > 3) {
                set_err("%s: JPEG table selector out of range", path);
                return false;
            }
            pred_sel = q[1 + 2 * ns];         // Ss = predictor selection
            pt = q[3 + 2 * ns] & 15;          // Al = point transform
            scan = qend;
            break;
        }
        p = qend;
    }
    if (!scan || w <= 0 || h <= 0) {
        set_err("%s: JPEG stream missing SOF3/SOS", path);
        return false;
    }
    if (P < 2 || P > 16) {
        set_err("%s: lossless JPEG precision out of range", path);
        return false;
    }
    if (w != want_w || h != want_h) {
        set_err("%s: JPEG frame size disagrees with Rows/Columns", path);
        return false;
    }
    if (!tables[tbl_id].present) {
        set_err("%s: JPEG scan references an undefined Huffman table",
                path);
        return false;
    }
    if (pred_sel < 1 || pred_sel > 7) {
        set_err("%s: invalid lossless JPEG predictor", path);
        return false;
    }
    *precision = P;

    samples.assign((size_t)w * h, 0);
    BitReader br(scan, end);
    const HuffTable &T = tables[tbl_id];
    const int32_t dflt = 1 << (P - pt - 1);
    int until_rst = ri;
    bool fresh = true;                        // start / just-restarted

    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            if (ri && !until_rst) {
                br.align_and_skip_rst();
                until_rst = ri;
                fresh = true;
            }
            int ssss = br.decode(T);
            if (ssss > 16) {
                set_err("%s: invalid JPEG difference category", path);
                return false;
            }
            int32_t diff = jls_extend(br.bits(ssss >= 16 ? 0 : ssss),
                                      ssss);
            if (br.bad) {
                set_err("%s: truncated JPEG entropy data", path);
                return false;
            }
            int32_t Ra = x > 0 ? samples[(size_t)y * w + x - 1] : 0;
            int32_t Rb = y > 0 ? samples[(size_t)(y - 1) * w + x] : 0;
            int32_t Rc = (x > 0 && y > 0)
                ? samples[(size_t)(y - 1) * w + x - 1] : 0;
            int32_t px;
            if (fresh) px = dflt;             // first sample after reset
            else if (y == 0) px = Ra;         // first line: left
            else if (x == 0) px = Rb;         // first column: above
            else switch (pred_sel) {          // T.81 table H.1
                case 1: px = Ra; break;
                case 2: px = Rb; break;
                case 3: px = Rc; break;
                case 4: px = Ra + Rb - Rc; break;
                case 5: px = Ra + ((Rb - Rc) >> 1); break;
                case 6: px = Rb + ((Ra - Rc) >> 1); break;
                default: px = (Ra + Rb) >> 1; break;
            }
            // Stay in the coded (point-transformed) domain - the
            // prediction neighbors above are coded-domain values too.
            samples[(size_t)y * w + x] = (uint16_t)((px + diff) & 0xFFFF);
            fresh = false;
            if (ri) until_rst--;
        }
    }
    if (pt)                                   // shift back up at output
        for (auto &s : samples) s = (uint16_t)(s << pt);
    return true;
}

// ------------------------- baseline/extended (DCT) JPEG decode (SOF0/1)

const double kPi = 3.14159265358979323846;

// 8x8 inverse DCT (T.81 A.3.3), straightforward separable float form.
void idct8x8(const double in[64], double out[64]) {
    static double C[8][8];
    static bool init = false;
    if (!init) {
        for (int u = 0; u < 8; u++)
            for (int x = 0; x < 8; x++)
                C[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) *
                    std::cos((2 * x + 1) * u * kPi / 16.0);
        init = true;
    }
    double tmp[64];
    for (int y = 0; y < 8; y++)                  // rows: over u
        for (int x = 0; x < 8; x++) {
            double s = 0;
            for (int u = 0; u < 8; u++) s += C[u][x] * in[y * 8 + u];
            tmp[y * 8 + x] = s;
        }
    for (int x = 0; x < 8; x++)                  // cols: over v
        for (int y = 0; y < 8; y++) {
            double s = 0;
            for (int v = 0; v < 8; v++) s += C[v][y] * tmp[v * 8 + x];
            out[y * 8 + x] = s;
        }
}

const uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Decode one SOF0/SOF1 stream (1 or 3 components, sampling factors 1-2,
// one interleaved scan) into samples[w*h*ncomp], component-interleaved.
// Subsampled chroma planes are upsampled by sample replication. The
// reference decodes through DCMTK's IJG plugin (dipijpeg.h,
// reference imutil/dicom.cpp:70,842) but then REJECTS any
// non-monochrome result (dicom.cpp:575-580); supporting color decode
// here exceeds the reference.
bool jdct_decode(const uint8_t *buf, size_t len, int want_w, int want_h,
                 std::vector<uint16_t> &samples, int *precision,
                 const char *path, int *ncomp_out) {
    const uint8_t *p = buf, *end = buf + len;
    auto u16be = [&](const uint8_t *q) {
        return (int)((q[0] << 8) | q[1]);
    };
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) {
        set_err("%s: fragment is not a JPEG stream", path);
        return false;
    }
    p += 2;
    HuffTable dc_tab[4], ac_tab[4];
    uint16_t qt[4][64] = {};
    bool have_qt[4] = {};
    int P = 0, w = 0, h = 0, ri = 0;
    int sof = 0;
    struct JComp { int id = 0, hs = 1, vs = 1, tq = 0, td = 0, ta = 0; };
    JComp comps[3];
    int ncomp = 0;
    const uint8_t *scan = nullptr;

    while (p + 4 <= end) {
        if (p[0] != 0xFF) { p++; continue; }
        int m = p[1];
        if (m == 0xFF) { p++; continue; }
        p += 2;
        if (m == 0xD9) break;
        int seglen = u16be(p);
        if (p + seglen > end || seglen < 2) {
            set_err("%s: truncated JPEG segment", path);
            return false;
        }
        const uint8_t *q = p + 2, *qend = p + seglen;
        const size_t seg_avail = (size_t)(qend - q);
        if (m == 0xC0 || m == 0xC1) {            // SOF0 / SOF1
            if (seg_avail < 9) {
                set_err("%s: truncated JPEG SOF segment", path);
                return false;
            }
            sof = m;
            P = q[0];
            h = u16be(q + 1);
            w = u16be(q + 3);
            ncomp = q[5];
            if (ncomp != 1 && ncomp != 3) {
                set_err("%s: only 1- or 3-component DCT JPEG is "
                        "supported", path);
                return false;
            }
            if (seg_avail < (size_t)(6 + 3 * ncomp)) {
                set_err("%s: truncated JPEG SOF segment", path);
                return false;
            }
            for (int c = 0; c < ncomp; c++) {
                comps[c].id = q[6 + 3 * c];
                comps[c].hs = q[7 + 3 * c] >> 4;
                comps[c].vs = q[7 + 3 * c] & 15;
                comps[c].tq = q[8 + 3 * c] & 15;
                if (comps[c].tq > 3) {
                    set_err("%s: JPEG quant-table selector out of range",
                            path);
                    return false;
                }
                if (comps[c].hs < 1 || comps[c].hs > 2 ||
                    comps[c].vs < 1 || comps[c].vs > 2) {
                    set_err("%s: JPEG subsampling factor out of the "
                            "supported 1-2 range", path);
                    return false;
                }
            }
        } else if (m == 0xC4) {                  // DHT
            while (q + 17 <= qend) {
                int tc = q[0] >> 4, th = q[0] & 15;
                int nv = 0;
                for (int i = 0; i < 16; i++) nv += q[1 + i];
                if (q + 17 + nv > qend) break;
                if (th < 4) {
                    if (tc == 0) dc_tab[th].build(q + 1, q + 17, nv);
                    else if (tc == 1) ac_tab[th].build(q + 1, q + 17, nv);
                }
                q += 17 + nv;
            }
        } else if (m == 0xDB) {                  // DQT
            while (q < qend) {
                int pq = q[0] >> 4, tq = q[0] & 15;
                q++;
                if (tq > 3 || qend - q < (pq ? 128 : 64)) {
                    set_err("%s: truncated JPEG DQT segment", path);
                    return false;
                }
                for (int i = 0; i < 64; i++) {
                    if (pq) { qt[tq][i] = (uint16_t)u16be(q); q += 2; }
                    else qt[tq][i] = *q++;
                }
                have_qt[tq] = true;
            }
        } else if (m == 0xDD) {
            if (seg_avail < 2) {
                set_err("%s: truncated JPEG DRI segment", path);
                return false;
            }
            ri = u16be(q);
        } else if (m == 0xDA) {                  // SOS
            if (seg_avail < 1 || (int)q[0] != ncomp ||
                seg_avail < (size_t)(1 + 2 * ncomp + 3)) {
                set_err("%s: JPEG scan does not cover all frame "
                        "components in one interleaved pass", path);
                return false;
            }
            for (int j = 0; j < ncomp; j++) {
                const int cs = q[1 + 2 * j];
                int c = -1;
                for (int k = 0; k < ncomp; k++)
                    if (comps[k].id == cs) { c = k; break; }
                if (c < 0) {
                    set_err("%s: JPEG scan references an unknown "
                            "component", path);
                    return false;
                }
                comps[c].td = q[2 + 2 * j] >> 4;
                comps[c].ta = q[2 + 2 * j] & 15;
                if (comps[c].td > 3 || comps[c].ta > 3) {
                    set_err("%s: JPEG table selector out of range", path);
                    return false;
                }
            }
            scan = qend;
            break;
        } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xCF && m != 0xC8 &&
                                 m != 0xCC)) {
            set_err("%s: unsupported JPEG SOF for DCT decode", path);
            return false;
        }
        p = qend;
    }
    if (!scan || !sof || w <= 0 || h <= 0) {
        set_err("%s: JPEG stream missing SOF0/SOF1/SOS", path);
        return false;
    }
    // T.81 precision limits: Baseline (SOF0) is 8-bit; Extended (SOF1)
    // allows 8 or 12.
    if ((sof == 0xC0 && P != 8) ||
        (sof == 0xC1 && P != 8 && P != 12)) {
        set_err("%s: invalid JPEG sample precision for this process",
                path);
        return false;
    }
    for (int c = 0; c < ncomp; c++) {
        if (!have_qt[comps[c].tq]) {
            set_err("%s: JPEG scan references an undefined quantization "
                    "table", path);
            return false;
        }
        if (!dc_tab[comps[c].td].present || !ac_tab[comps[c].ta].present) {
            set_err("%s: JPEG scan references undefined Huffman tables",
                    path);
            return false;
        }
    }
    if (w != want_w || h != want_h) {
        set_err("%s: JPEG frame size disagrees with Rows/Columns", path);
        return false;
    }
    *precision = P;
    if (ncomp_out) *ncomp_out = ncomp;
    const int maxval = (1 << P) - 1;
    const int shift = 1 << (P - 1);
    int hmax = 1, vmax = 1;
    for (int c = 0; c < ncomp; c++) {
        hmax = std::max(hmax, comps[c].hs);
        vmax = std::max(vmax, comps[c].vs);
    }
    // MCU grid (T.81 A.2.3). Single-component scans degenerate to one
    // block per MCU, matching the pre-color single-plane layout.
    const int mcux = (w + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (h + 8 * vmax - 1) / (8 * vmax);
    int pw[3], ph[3];
    std::vector<uint16_t> plane[3];
    for (int c = 0; c < ncomp; c++) {
        pw[c] = mcux * 8 * comps[c].hs;
        ph[c] = mcuy * 8 * comps[c].vs;
        plane[c].assign((size_t)pw[c] * ph[c], 0);
    }

    BitReader br(scan, end);
    int32_t dc_pred[3] = {0, 0, 0};
    int until_rst = ri;
    for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
            if (ri && !until_rst) {
                br.align_and_skip_rst();
                until_rst = ri;
                for (int c = 0; c < ncomp; c++) dc_pred[c] = 0;
            }
            for (int c = 0; c < ncomp; c++)
                for (int by = 0; by < comps[c].vs; by++)
                    for (int bx = 0; bx < comps[c].hs; bx++) {
                        double blk[64] = {0};
                        const uint16_t *qtc = qt[comps[c].tq];
                        int t = br.decode(dc_tab[comps[c].td]);
                        // DCT DC categories stop at 11 (8-bit) / 15
                        // (12-bit); the lossless-only category-16
                        // convention is invalid here.
                        if (t > (P == 8 ? 11 : 15) || br.bad) {
                            set_err("%s: corrupt JPEG DC code", path);
                            return false;
                        }
                        dc_pred[c] += jls_extend(br.bits(t), t);
                        blk[0] = (double)dc_pred[c] * qtc[0];
                        for (int k = 1; k < 64;) {
                            int rs = br.decode(ac_tab[comps[c].ta]);
                            if (br.bad) {
                                set_err("%s: truncated JPEG entropy data",
                                        path);
                                return false;
                            }
                            int r = rs >> 4, s_ = rs & 15;
                            if (s_ == 0) {
                                if (r == 15) { k += 16; continue; }  // ZRL
                                break;                               // EOB
                            }
                            k += r;
                            if (k > 63) {
                                set_err("%s: corrupt JPEG AC run", path);
                                return false;
                            }
                            int32_t v = jls_extend(br.bits(s_), s_);
                            blk[kZigzag[k]] = (double)v * qtc[k];
                            k++;
                        }
                        double px[64];
                        idct8x8(blk, px);
                        const int oy = (my * comps[c].vs + by) * 8;
                        const int ox = (mx * comps[c].hs + bx) * 8;
                        uint16_t *dst = plane[c].data() +
                            (size_t)oy * pw[c] + ox;
                        for (int yy = 0; yy < 8; yy++)
                            for (int xx = 0; xx < 8; xx++) {
                                double v = px[yy * 8 + xx] + shift;
                                long iv = std::lround(v);
                                if (iv < 0) iv = 0;
                                if (iv > maxval) iv = maxval;
                                dst[(size_t)yy * pw[c] + xx] =
                                    (uint16_t)iv;
                            }
                    }
            if (ri) until_rst--;
        }

    // Interleave, upsampling subsampled planes by replication (DCMTK's
    // IJG plugin uses fancy upsampling; decoded values differ by <=1-2
    // codes near chroma edges, inside the 8-bit lossy budget).
    samples.assign((size_t)w * h * ncomp, 0);
    for (int c = 0; c < ncomp; c++) {
        const int hs = comps[c].hs, vs = comps[c].vs;
        for (int y = 0; y < h; y++) {
            const uint16_t *row = plane[c].data() +
                (size_t)(y * vs / vmax) * pw[c];
            uint16_t *out_row = samples.data() + (size_t)y * w * ncomp;
            for (int x = 0; x < w; x++)
                out_row[(size_t)x * ncomp + c] = row[x * hs / hmax];
        }
    }
    return true;
}

// Encode samples[w*h] (precision P bits) as an SV1 (predictor 1,
// Pt 0) lossless JPEG stream - the syntax the reference writes
// (dicom.cpp:1748). Huffman table is built fixed: length-(k+1) codes
// for categories k = 0..16 are one valid canonical assignment.
std::vector<uint8_t> jls_encode(const uint16_t *samples, int w, int h,
                                int P) {
    std::vector<uint8_t> out;
    auto b8 = [&](int v) { out.push_back((uint8_t)v); };
    auto b16 = [&](int v) { b8(v >> 8); b8(v & 0xFF); };
    b16(0xFFD8);                              // SOI
    // DHT: counts[l] = 1 for l = 1..16, one value per length; value k
    // (category) gets the length-(k+1) code, except category 16 shares
    // length 16. Simpler: categories 0..15 at lengths 1..16; category
    // 16 cannot fit - use counts {0,1,...}: put two values at length 16.
    uint8_t counts[16] = {0};
    uint8_t vals[17];
    for (int k = 0; k < 15; k++) { counts[k] = 1; vals[k] = (uint8_t)k; }
    counts[15] = 2;                           // lengths: 1..15 + two 16s
    vals[15] = 15; vals[16] = 16;
    b16(0xFFC4); b16(2 + 1 + 16 + 17); b8(0x00);
    for (int i = 0; i < 16; i++) b8(counts[i]);
    for (int i = 0; i < 17; i++) b8(vals[i]);
    // SOF3
    b16(0xFFC3); b16(11); b8(P); b16(h); b16(w); b8(1);
    b8(1); b8(0x11); b8(0);                   // comp 1, 1x1 sampling, Tq 0
    // SOS: Ss = 1 (SV1 predictor), Se = 0, Ah:Al = 0:0
    b16(0xFFDA); b16(8); b8(1); b8(1); b8(0x00); b8(1); b8(0); b8(0);

    // Canonical codes for the table above: category k < 15 -> code of
    // length k+1 = (2^(k+1) - 2); categories 15, 16 -> length-16 codes.
    auto codeof = [&](int k, uint32_t &code, int &len) {
        if (k < 15) { len = k + 1; code = (1u << len) - 2; }
        else { len = 16; code = 0xFFFE + (k - 15); }
    };
    uint32_t acc = 0;
    int nacc = 0;
    auto put = [&](uint32_t code, int len) {
        acc = (acc << len) | code;
        nacc += len;
        while (nacc >= 8) {
            uint8_t byte = (uint8_t)(acc >> (nacc - 8));
            out.push_back(byte);
            if (byte == 0xFF) out.push_back(0x00);   // byte stuffing
            nacc -= 8;
        }
        acc &= (1u << nacc) - 1;
    };
    const int32_t dflt = 1 << (P - 1);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int32_t px;
            if (x == 0 && y == 0) px = dflt;
            else if (y == 0) px = samples[x - 1];
            else if (x == 0) px = samples[(size_t)(y - 1) * w];
            else px = samples[(size_t)y * w + x - 1];          // SV1: Ra
            int32_t diff = (int32_t)((samples[(size_t)y * w + x] - px)
                                     & 0xFFFF);
            if (diff > 32767) diff -= 65536;
            int ssss;
            uint32_t extra = 0;
            if (diff == 32768 || diff == -32768) ssss = 16;
            else {
                uint32_t mag = (uint32_t)(diff < 0 ? -diff : diff);
                ssss = 0;
                while (mag >> ssss) ssss++;
                extra = diff >= 0 ? (uint32_t)diff
                                  : (uint32_t)(diff - 1) & ((1u << ssss) - 1);
            }
            uint32_t code; int len;
            codeof(ssss, code, len);
            put(code, len);
            if (ssss && ssss < 16) put(extra, ssss);
        }
    if (nacc) put((1u << (8 - nacc)) - 1, 8 - nacc);   // pad with 1s
    b16(0xFFD9);                              // EOI
    return out;
}

// Decode every encapsulated frame into f.pixel_data (native LE layout
// that copy_pixels consumes).
int decode_encapsulated(DcmFile &f, const char *path) {
    const int nf = std::max(1, f.frames);
    const size_t frag_n = f.fragments.size();
    if (!frag_n) {
        set_err("%s: encapsulated pixel data has no fragments", path);
        return S3D_FAILURE;
    }
    // Group fragments by frame: single frame takes all fragments;
    // otherwise 1:1 when counts match, else split by the Basic Offset
    // Table (offsets of each frame's first fragment item header).
    std::vector<std::pair<size_t, size_t>> groups;   // [first, last)
    if (nf == 1) {
        groups.push_back({0, frag_n});
    } else if ((size_t)nf == frag_n) {
        for (size_t i = 0; i < frag_n; i++) groups.push_back({i, i + 1});
    } else if (f.bot.size() == (size_t)nf) {
        std::vector<uint32_t> starts(frag_n);
        uint32_t off = 0;
        for (size_t i = 0; i < frag_n; i++) {
            starts[i] = off;
            off += 8 + (uint32_t)f.fragments[i].size();
        }
        size_t k = 0;
        for (int fr = 0; fr < nf; fr++) {
            while (k < frag_n && starts[k] < f.bot[fr]) k++;
            const size_t first = k;
            uint32_t next = fr + 1 < nf ? f.bot[fr + 1] : 0xFFFFFFFFu;
            size_t last = first;
            while (last < frag_n && starts[last] < next) last++;
            groups.push_back({first, last});
            k = last;
        }
    } else {
        set_err("%s: cannot map %s fragments to frames", path,
                std::to_string(frag_n).c_str());
        return S3D_FAILURE;
    }

    const int bytes_per = f.bits_alloc > 8 ? 2 : 1;
    const int nc = std::max(1, f.nc);
    if (nc != 1 && !f.lossy_dct) {
        set_err("%s: multi-component lossless JPEG is not supported",
                path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    const size_t frame_sm = (size_t)f.rows * f.cols * nc;
    f.pixel_data.assign(frame_sm * nf * bytes_per, 0);
    for (int fr = 0; fr < nf; fr++) {
        std::vector<uint8_t> stream;
        for (size_t i = groups[fr].first; i < groups[fr].second; i++)
            stream.insert(stream.end(), f.fragments[i].begin(),
                          f.fragments[i].end());
        std::vector<uint16_t> samples;
        int P = 0, ncomp = 1;
        const bool ok = f.lossy_dct
            ? jdct_decode(stream.data(), stream.size(), f.cols, f.rows,
                          samples, &P, path, &ncomp)
            : jls_decode(stream.data(), stream.size(), f.cols, f.rows,
                         samples, &P, path);
        if (!ok)
            return S3D_UNSUPPORTED_FILE_TYPE;
        if (ncomp != nc) {
            set_err("%s: JPEG component count disagrees with "
                    "SamplesPerPixel", path);
            return S3D_FAILURE;
        }
        if (P > 8 && bytes_per == 1) {
            set_err("%s: JPEG precision exceeds BitsAllocated=8", path);
            return S3D_FAILURE;
        }
        uint8_t *dst = f.pixel_data.data() + frame_sm * bytes_per * fr;
        for (size_t i = 0; i < frame_sm; i++) {
            if (bytes_per == 1) dst[i] = (uint8_t)samples[i];
            else memcpy(dst + 2 * i, &samples[i], 2);
        }
    }
    f.fragments.clear();
    return S3D_SUCCESS;
}

int parse_file(const char *path, DcmFile &f, bool want_pixels) {
    FILE *fp = fopen(path, "rb");
    if (!fp) { set_err("cannot open %s", path); return S3D_FILE_DOES_NOT_EXIST; }
    fseek(fp, 0, SEEK_END);
    long size = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    std::vector<uint8_t> buf((size_t)std::max(size, 0L));
    if (size <= 0 || fread(buf.data(), 1, (size_t)size, fp) != (size_t)size) {
        fclose(fp);
        set_err("cannot read %s", path);
        return S3D_FAILURE;
    }
    fclose(fp);

    if (size < 132 + 8 || memcmp(buf.data() + 128, "DICM", 4) != 0) {
        set_err("%s is not a Part-10 DICOM file", path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }

    Parser ps{buf.data() + 132, buf.data() + size, true};

    // File meta group (always explicit LE)
    while (ps.avail(8)) {
        const uint8_t *save = ps.p;
        Tag t; std::string vr; uint32_t len;
        if (!ps.header(t, vr, len)) break;
        if (t.group != 0x0002) { ps.p = save; break; }
        if (len == 0xFFFFFFFFu || !ps.avail(len)) {
            set_err("%s: malformed meta group", path);
            return S3D_FAILURE;
        }
        if (t == kTransferSyntax)
            f.transfer_syntax = trim(std::string((const char *)ps.p, len));
        ps.p += len;
    }

    if (f.transfer_syntax == UID_ImplicitLE) {
        ps.explicit_vr = false;
    } else if (f.transfer_syntax == UID_ExplicitLE ||
               f.transfer_syntax.empty()) {
        ps.explicit_vr = true;
    } else if (f.transfer_syntax == UID_ExplicitBE) {
        // Retired Explicit VR Big Endian: DCMTK reads it natively for
        // the reference, so archives it accepts may carry it.
        ps.explicit_vr = true;
        ps.big_endian = true;
        f.big_endian = true;
    } else if (f.transfer_syntax == UID_JPEGLosslessSV1 ||
               f.transfer_syntax == UID_JPEGLossless14) {
        ps.explicit_vr = true;
        f.encapsulated = true;
    } else if (f.transfer_syntax == UID_JPEGBaseline ||
               f.transfer_syntax == UID_JPEGExtended) {
        ps.explicit_vr = true;
        f.encapsulated = true;
        f.lossy_dct = true;
    } else {
        set_err("%s: unsupported transfer syntax %s (uncompressed "
                "little-endian and lossless JPEG are supported)", path,
                f.transfer_syntax.c_str());
        return S3D_UNSUPPORTED_FILE_TYPE;
    }

    // Element consumer; depth > 0 means inside a sequence item, where
    // only the sequence-searchable SUV tags are consumed (the DCMTK
    // searchIntoSub behavior, dicom.cpp:669-726).
    auto consume = [&](Tag t, const std::string &vr, const uint8_t *v,
                       uint32_t len, int depth, bool in_ref_series) {
        auto as_str = [&]() { return trim(std::string((const char *)v, len)); };
        auto as_us = [&]() -> long {
            if (len == 2) {
                uint16_t x; memcpy(&x, v, 2);
                return f.big_endian ? (uint16_t)((x >> 8) | (x << 8)) : x;
            }
            return atol(as_str().c_str());
        };
        auto as_int = [&]() -> long { return atol(as_str().c_str()); };
        (void)vr;

        // Searched at any depth:
        if (t == kPatientWeight)
            parse_multi_double(as_str(), &f.weight, 1);
        else if (t == kRadioTotalDose)
            parse_multi_double(as_str(), &f.dose, 1);
        else if (t == kRadioHalfLife)
            parse_multi_double(as_str(), &f.half_life, 1);
        else if (t == kRadioStartTime)
            parse_tm(as_str(), &f.radio_start_time);
        else if (t == kAcquisitionTime)
            parse_tm(as_str(), &f.acq_time);
        // Per-frame UID references: only those under ReferencedSeries-
        // Sequence (0008,1115) -> ReferencedInstanceSequence count
        // (reference read_dso, dicom.cpp:1049-1063). Real DSOs also
        // carry (0008,1155) in PerFrameFunctionalGroups Derivation/
        // SourceImageSequence, which must NOT inflate the frame map.
        else if (t == kRefSOPInstance && in_ref_series)
            f.ref_instance_uids.push_back(as_str());
        else if (t == kSegmentNumber)
            f.n_segments++;
        if (depth > 0)
            return;

        if (t == kSOPClassUID) f.sop_class = as_str();
        else if (t == kSOPInstanceUID) f.sop_instance = as_str();
        else if (t == kSeriesUID) f.series_uid = as_str();
        else if (t == kImagePosition) {
            f.has_pos = parse_multi_double(as_str(), f.im_pos, 3);
        } else if (t == kImageOrientation) {
            f.has_ori = parse_multi_double(as_str(), f.im_ori, 6);
        } else if (t == kPixelSpacing) {
            f.has_spacing = parse_multi_double(as_str(), f.pixel_spacing, 2);
        } else if (t == kSliceThickness) {
            f.has_thickness = parse_multi_double(as_str(),
                                                 &f.slice_thickness, 1);
        } else if (t == kRescaleSlope) {
            parse_multi_double(as_str(), &f.rescale_slope, 1);
        } else if (t == kRescaleIntercept) {
            parse_multi_double(as_str(), &f.rescale_intercept, 1);
        } else if (t == kRows) f.rows = (int)as_us();
        else if (t == kColumns) f.cols = (int)as_us();
        else if (t == kNumberOfFrames) f.frames = std::max(1, (int)as_int());
        else if (t == kSamplesPerPixel) f.nc = std::max(1, (int)as_us());
        else if (t == kPhotometric) f.photometric = as_str();
        else if (t == kPlanarConfig) f.planar = (int)as_us();
        else if (t == kBitsAllocated) f.bits_alloc = (int)as_us();
        else if (t == kPixelRep) f.pixel_rep = (int)as_us();
        else if (t == kPixelData) {
            if (want_pixels) f.pixel_data.assign(v, v + len);
        } else {
            for (int c = 0; c < 3; c++) {
                if (t == kPaletteDesc[c] && len >= 6) {
                    for (int j = 0; j < 3; j++) {
                        uint16_t x; memcpy(&x, v + 2 * j, 2);
                        f.pal_desc[c][j] = f.big_endian
                            ? (uint16_t)((x >> 8) | (x << 8)) : x;
                    }
                    f.has_pal_desc[c] = true;
                } else if (t == kPaletteData[c]) {
                    f.pal_data[c].assign(v, v + len);
                }
            }
        }
    };

    // Walk elements, descending into sequences. Returns false on a
    // malformed stream. stop_tag: FFFE,E00D (item end) / FFFE,E0DD
    // (sequence end) terminate the enclosing scope.
    std::function<bool(Parser &, int, bool)> walk =
        [&](Parser &pr, int depth, bool in_ref_series) -> bool {
        while (pr.avail(8)) {
            Tag t; std::string vr; uint32_t len;
            if (!pr.header(t, vr, len)) return depth == 0;
            if (t.group == 0xFFFE &&
                (t.elem == 0xE00D || t.elem == 0xE0DD))
                return true;                      // end of this scope
            if (t == kPixelData && len == 0xFFFFFFFFu) {
                // Encapsulated pixel data (PS3.5 A.4): first item is the
                // Basic Offset Table, the rest are codec fragments.
                bool first = true;
                for (;;) {
                    Tag it; std::string ivr; uint32_t ilen;
                    if (!pr.header(it, ivr, ilen)) return false;
                    if (it.group == 0xFFFE && it.elem == 0xE0DD) break;
                    if (!(it.group == 0xFFFE && it.elem == 0xE000) ||
                        ilen == 0xFFFFFFFFu || !pr.avail(ilen))
                        return false;
                    if (first) {
                        for (uint32_t o = 0; o + 4 <= ilen; o += 4) {
                            uint32_t v;
                            memcpy(&v, pr.p + o, 4);
                            f.bot.push_back(v);
                        }
                        first = false;
                    } else if (want_pixels) {
                        f.fragments.emplace_back(pr.p, pr.p + ilen);
                    }
                    pr.p += ilen;
                }
                continue;
            }
            // Implicit VR gives no "SQ" marker for defined-length
            // sequences; detect them by peeking for an item header
            // (FFFE,E000) at the value start, so tags nested inside
            // e.g. RadiopharmaceuticalInformationSequence are still
            // found (DCMTK searchIntoSub reaches them regardless of
            // VR encoding; reference dicom.cpp:669-726).
            const bool implicit_defined_sq =
                !pr.explicit_vr && vr.empty() && len != 0xFFFFFFFFu &&
                !(t == kPixelData) && len >= 8 && pr.avail(8) &&
                pr.p[0] == 0xFE && pr.p[1] == 0xFF &&
                pr.p[2] == 0x00 && pr.p[3] == 0xE0;
            const bool is_sq = vr == "SQ" ||
                (len == 0xFFFFFFFFu && !(t == kPixelData)) ||
                implicit_defined_sq;
            if (is_sq) {
                const bool sub_ref = in_ref_series || t == kRefSeriesSeq;
                if (len == 0xFFFFFFFFu) {
                    // Items until the FFFE,E0DD delimiter.
                    for (;;) {
                        Tag it; std::string ivr; uint32_t ilen;
                        if (!pr.header(it, ivr, ilen)) return false;
                        if (it.group == 0xFFFE && it.elem == 0xE0DD) break;
                        if (!(it.group == 0xFFFE && it.elem == 0xE000))
                            return false;
                        if (ilen == 0xFFFFFFFFu) {
                            if (!walk(pr, depth + 1, sub_ref)) return false;
                        } else {
                            if (!pr.avail(ilen)) return false;
                            Parser sub{pr.p, pr.p + ilen, pr.explicit_vr,
                                       pr.big_endian};
                            if (!walk(sub, depth + 1, sub_ref)) return false;
                            pr.p += ilen;
                        }
                    }
                } else {
                    if (!pr.avail(len)) return false;
                    Parser sub{pr.p, pr.p + len, pr.explicit_vr,
                               pr.big_endian};
                    // Items with defined lengths inside; walk handles
                    // the FFFE,E000 headers as plain elements below.
                    for (;;) {
                        Tag it; std::string ivr; uint32_t ilen;
                        if (!sub.avail(8)) break;
                        if (!sub.header(it, ivr, ilen)) break;
                        if (!(it.group == 0xFFFE && it.elem == 0xE000))
                            break;
                        if (ilen == 0xFFFFFFFFu) {
                            if (!walk(sub, depth + 1, sub_ref)) return false;
                        } else {
                            if (!sub.avail(ilen)) break;
                            Parser isub{sub.p, sub.p + ilen,
                                        sub.explicit_vr, sub.big_endian};
                            if (!walk(isub, depth + 1, sub_ref))
                                return false;
                            sub.p += ilen;
                        }
                    }
                    pr.p += len;
                }
                continue;
            }
            if (len == 0xFFFFFFFFu || !pr.avail(len)) return false;
            consume(t, vr, pr.p, len, depth, in_ref_series);
            pr.p += len;
        }
        return true;
    };

    if (!walk(ps, 0, false)) {
        set_err("%s: malformed element stream", path);
        return S3D_FAILURE;
    }

    if (f.rows <= 0 || f.cols <= 0) {
        set_err("%s: missing Rows/Columns", path);
        return S3D_FAILURE;
    }
    if (f.encapsulated && want_pixels) {
        int rc = decode_encapsulated(f, path);
        if (rc != S3D_SUCCESS) return rc;
    }
    return S3D_SUCCESS;
}

// Reference Dicom-class geometry (dicom.cpp:485-563)
struct Geometry {
    int axes[2] = {0, 1};      // volume axes of the (col, row) directions
    int signs[2] = {1, 1};
    int sort_axis = 2;
    double sort_coord = 0;
    double units[3] = {1, 1, 1};
    double sort_unit = 1;      // slice thickness
};

int compute_geometry(const DcmFile &f, Geometry &g, const char *path) {
    const double *o1 = f.im_ori, *o2 = f.im_ori + 3;
    // normal = o1 x o2
    double n[3] = {o1[1] * o2[2] - o1[2] * o2[1],
                   o1[2] * o2[0] - o1[0] * o2[2],
                   o1[0] * o2[1] - o1[1] * o2[0]};
    g.sort_coord = f.im_pos[0] * n[0] + f.im_pos[1] * n[1] +
                   f.im_pos[2] * n[2];
    double vals[2];
    for (int k = 0; k < 2; k++) {
        const double *o = k == 0 ? o1 : o2;
        int best = 0;
        for (int i = 1; i < 3; i++)
            if (std::fabs(o[i]) > std::fabs(o[best])) best = i;
        g.axes[k] = best;
        vals[k] = o[best];
        g.signs[k] = vals[k] >= 0 ? 1 : -1;
    }
    if (g.axes[0] == g.axes[1]) {
        set_err("%s: degenerate ImageOrientationPatient", path);
        return S3D_FAILURE;
    }
    for (int k = 0; k < 3; k++) {
        if (g.axes[0] != k && g.axes[1] != k) { g.sort_axis = k; break; }
    }
    if (f.has_spacing) {
        if (f.pixel_spacing[0] <= 0 || f.pixel_spacing[1] <= 0) {
            set_err("%s: invalid pixel spacing", path);
            return S3D_FAILURE;
        }
        g.units[g.axes[0]] = f.pixel_spacing[0];
        g.units[g.axes[1]] = f.pixel_spacing[1];
    }
    if (f.has_thickness) {
        if (f.slice_thickness <= 0) {
            set_err("%s: invalid slice thickness", path);
            return S3D_FAILURE;
        }
        g.units[g.sort_axis] = f.slice_thickness;
        g.sort_unit = f.slice_thickness;
    }
    return S3D_SUCCESS;
}

// The output channel count of a parsed file: palette-color images carry
// one stored sample but expand to RGB on read (what DCMTK's DiColorImage
// would produce; the reference itself REJECTS every non-monochrome read,
// dicom.cpp:575-580, so all color paths here exceed it).
int out_nc(const DcmFile &f) {
    return f.photometric == "PALETTE COLOR" ? 3 : f.nc;
}

// Copy decoded pixels into a (nz, ny, nx[, nc]) float volume with the
// reference's sign-flip semantics (read_dcm_img, dicom.cpp:867-921).
// Color support (all beyond the reference, which rejects color reads at
// dicom.cpp:575-580): interleaved and planar (PlanarConfiguration 1)
// RGB, YBR_FULL / YBR_FULL_422 -> RGB conversion (uncompressed and
// JPEG), and PALETTE COLOR LUT expansion to RGB.
int copy_pixels(const DcmFile &f, const Geometry &g, float *out,
                const char *path) {
    const int nx = f.cols, ny = f.rows, nz = f.frames, nc = f.nc;
    const bool palette = f.photometric == "PALETTE COLOR";
    const bool ybr_full = f.photometric == "YBR_FULL";
    const bool ybr_422 = f.photometric == "YBR_FULL_422";
    const int nco = palette ? 3 : nc;
    if (nc != 1 && nc != 3) {
        set_err("%s: only 1- or 3-channel DICOM is supported", path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    if (palette && nc != 1) {
        set_err("%s: PALETTE COLOR requires SamplesPerPixel=1", path);
        return S3D_FAILURE;
    }
    if ((ybr_full || ybr_422) && (nc != 3 || f.bits_alloc != 8)) {
        set_err("%s: YBR photometric requires 3 8-bit samples", path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    if (nc == 3 && f.bits_alloc == 1) {
        set_err("%s: 1-bit RGB is not supported", path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    // Planar layout survives only on uncompressed streams; encapsulated
    // frames decode to interleaved samples. Uncompressed YBR_FULL_422
    // stores 2 samples/pixel groups (Y0 Y1 Cb Cr), always interleaved.
    const bool planar = nc == 3 && f.planar != 0 && !f.encapsulated;
    const bool sub422 = ybr_422 && !f.encapsulated;
    if (sub422 && (nx % 2 || planar)) {
        set_err("%s: malformed YBR_FULL_422 geometry", path);
        return S3D_FAILURE;
    }
    const size_t n = sub422 ? (size_t)nx * ny * nz * 2
                            : (size_t)nx * ny * nz * nc;
    size_t bytes = f.bits_alloc == 1 ? (n + 7) / 8
                                      : (size_t)f.bits_alloc / 8 * n;
    if (f.pixel_data.size() < bytes) {
        set_err("%s: pixel data too short", path);
        return S3D_FAILURE;
    }

    // Palette LUTs (PS3.3 C.7.6.3.1.5-6): descriptor = (entries with
    // 0 meaning 65536, first stored value mapped, bits per entry).
    struct Lut {
        long n = 0, first = 0;
        int bits = 8;
        const uint8_t *data = nullptr;
        size_t len = 0;
    } lut[3];
    if (palette) {
        for (int c = 0; c < 3; c++) {
            if (!f.has_pal_desc[c] || f.pal_data[c].empty()) {
                set_err("%s: PALETTE COLOR image is missing its LUTs",
                        path);
                return S3D_FAILURE;
            }
            lut[c].n = f.pal_desc[c][0] == 0 ? 65536 : f.pal_desc[c][0];
            lut[c].first = f.pixel_rep
                ? (long)(int16_t)f.pal_desc[c][1] : (long)f.pal_desc[c][1];
            lut[c].bits = f.pal_desc[c][2];
            lut[c].data = f.pal_data[c].data();
            lut[c].len = f.pal_data[c].size();
            const size_t need = lut[c].bits > 8 ? 2 * (size_t)lut[c].n
                                                : (size_t)lut[c].n;
            if (lut[c].len < need) {
                set_err("%s: palette LUT data shorter than its "
                        "descriptor", path);
                return S3D_FAILURE;
            }
        }
    }
    auto lut_at = [&](const Lut &l, long v) -> double {
        long idx = v - l.first;
        if (idx < 0) idx = 0;
        if (idx >= l.n) idx = l.n - 1;
        if (l.bits > 8) {
            uint16_t x;
            memcpy(&x, l.data + 2 * idx, 2);
            return f.big_endian ? (double)((x >> 8) | (x << 8))
                                : (double)x;
        }
        return (double)l.data[idx];
    };
    int dims[3] = {nx, ny, nz};
    int signs[3] = {1, 1, 1}, offsets[3] = {0, 0, 0};
    for (int k = 0; k < 2; k++) {
        if (g.signs[k] > 0) continue;
        int a = g.axes[k];
        if (a > 2) continue;
        signs[a] = -1;
        offsets[a] = dims[a] - 1;
    }
    // PET modality post-processing: SUV multiplier (dicom.cpp:646-740).
    double suv = 1.0;
    if (f.sop_class == UID_PET) {
        if (f.weight < 0 || f.dose < 0 || f.half_life <= 0 ||
            f.radio_start_time < 0 || f.acq_time < 0) {
            set_err("%s: PET image is missing SUV metadata (weight/dose/"
                    "half-life/times)", path);
            return S3D_FAILURE;
        }
        double elapsed = f.radio_start_time - f.acq_time;
        if (elapsed < 0)
            elapsed += 24.0 * 60.0 * 60.0;
        const double adjusted = f.dose * std::pow(2.0, -elapsed /
                                                  f.half_life);
        suv = f.weight / adjusted;
    }

    const double slope = f.rescale_slope, inter = f.rescale_intercept;
    auto store = [&](int x, int y, int z, int c, double v) {
        int xi = x * signs[0] + offsets[0];
        int yi = y * signs[1] + offsets[1];
        int zi = z * signs[2] + offsets[2];
        out[(((size_t)zi * ny + yi) * nx + xi) * nco + c] =
            (float)((v * slope + inter) * suv);
    };
    const uint8_t *d = f.pixel_data.data();
    if (f.bits_alloc != 1 && f.bits_alloc != 8 && f.bits_alloc != 16 &&
        f.bits_alloc != 32) {
        set_err("%s: unsupported bit depth", path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    // Stored sample i as a double (endianness per transfer syntax).
    auto fetch = [&](size_t i) -> double {
        switch (f.bits_alloc) {
        case 1:
            // Binary segmentation frames: bit-packed, LSB first
            // (PS3.5 8.1.1; DcmSegmentation unpacks the same way).
            return (double)((d[i >> 3] >> (i & 7)) & 1);
        case 8:
            return f.pixel_rep ? (double)((const int8_t *)d)[i]
                               : (double)d[i];
        case 16: {
            uint16_t x16; memcpy(&x16, d + 2 * i, 2);
            if (f.big_endian) x16 = (uint16_t)((x16 >> 8) | (x16 << 8));
            return f.pixel_rep ? (double)(int16_t)x16 : (double)x16;
        }
        default: {
            uint32_t x32; memcpy(&x32, d + 4 * i, 4);
            if (f.big_endian) x32 = __builtin_bswap32(x32);
            return f.pixel_rep ? (double)(int32_t)x32 : (double)x32;
        }
        }
    };
    // Full-range YCbCr -> RGB (PS3.3 C.7.6.3.1.2 / JFIF).
    auto ycbcr = [](double vals[3]) {
        const double Y = vals[0], cb = vals[1] - 128, cr = vals[2] - 128;
        double rgb[3] = {Y + 1.402 * cr,
                         Y - 0.344136 * cb - 0.714136 * cr,
                         Y + 1.772 * cb};
        for (int c = 0; c < 3; c++)
            vals[c] = rgb[c] < 0 ? 0 : (rgb[c] > 255 ? 255 : rgb[c]);
    };
    const bool to_rgb = ybr_full || ybr_422;
    for (int z = 0; z < nz; z++)
        for (int y = 0; y < ny; y++)
            for (int x = 0; x < nx; x++) {
                double vals[3];
                const size_t px = ((size_t)z * ny + y) * nx + x;
                if (sub422) {
                    // Uncompressed 4:2:2: (Y0 Y1 Cb Cr) per 2 pixels.
                    const size_t grp =
                        (((size_t)z * ny + y) * nx + (x & ~1)) * 2;
                    vals[0] = fetch(grp + (x & 1));
                    vals[1] = fetch(grp + 2);
                    vals[2] = fetch(grp + 3);
                } else if (nc == 3) {
                    for (int c = 0; c < 3; c++)
                        vals[c] = fetch(planar
                            ? (((size_t)z * 3 + c) * ny + y) * nx + x
                            : px * 3 + c);
                } else if (palette) {
                    const long v = std::lround(fetch(px));
                    for (int c = 0; c < 3; c++)
                        vals[c] = lut_at(lut[c], v);
                } else {
                    vals[0] = fetch(px);
                }
                if (to_rgb)
                    ycbcr(vals);
                for (int c = 0; c < nco; c++)
                    store(x, y, z, c, vals[c]);
            }
    return S3D_SUCCESS;
}

// ------------------------------------------------------------- writing

struct Writer {
    std::vector<uint8_t> out;

    void raw(const void *p, size_t n) {
        const uint8_t *b = (const uint8_t *)p;
        out.insert(out.end(), b, b + n);
    }
    void w16(uint16_t v) { raw(&v, 2); }
    void w32(uint32_t v) { raw(&v, 4); }

    void element(Tag t, const char *vr, const void *val, size_t len) {
        // pad to even length
        std::vector<uint8_t> padded((const uint8_t *)val,
                                    (const uint8_t *)val + len);
        if (padded.size() % 2)
            padded.push_back(strcmp(vr, "UI") == 0 ? 0 : ' ');
        w16(t.group); w16(t.elem);
        raw(vr, 2);
        if (!strcmp(vr, "OB") || !strcmp(vr, "OW") || !strcmp(vr, "SQ") ||
            !strcmp(vr, "UN") || !strcmp(vr, "UT")) {
            w16(0);
            w32((uint32_t)padded.size());
        } else {
            w16((uint16_t)padded.size());
        }
        raw(padded.data(), padded.size());
    }
    void str(Tag t, const char *vr, const std::string &s) {
        element(t, vr, s.data(), s.size());
    }
    void us(Tag t, uint16_t v) { element(t, "US", &v, 2); }

    // Encapsulated PixelData (PS3.5 A.4): undefined-length OB, a Basic
    // Offset Table item with per-frame byte offsets, one even-padded
    // fragment per frame, then the sequence delimiter.
    void encapsulated_pixels(const std::vector<std::vector<uint8_t>> &fr) {
        w16(kPixelData.group); w16(kPixelData.elem);
        raw("OB", 2); w16(0); w32(0xFFFFFFFFu);
        std::vector<uint32_t> offs;
        uint32_t off = 0;
        for (const auto &f : fr) {
            offs.push_back(off);
            off += 8 + (uint32_t)((f.size() + 1) & ~(size_t)1);
        }
        w16(0xFFFE); w16(0xE000); w32(4 * (uint32_t)offs.size());
        for (uint32_t o : offs) w32(o);
        for (const auto &f : fr) {
            w16(0xFFFE); w16(0xE000);
            w32((uint32_t)((f.size() + 1) & ~(size_t)1));
            raw(f.data(), f.size());
            if (f.size() % 2) { uint8_t z = 0; raw(&z, 1); }
        }
        w16(0xFFFE); w16(0xE0DD); w32(0);
    }
};

std::string gen_uid() {
    static std::mt19937_64 rng(0x51F73D);
    std::string s(UID_ROOT);
    for (int i = 0; i < 20; i++) s += char('0' + rng() % 10);
    return s;
}

int write_single(const char *path, const float *data, int nx, int ny,
                 int nz, double ux, double uy, double uz,
                 unsigned instance_num, const char *series_uid,
                 const char *instance_uid, float max_val,
                 bool jpeg = false, int nc = 1) {
    char buf[256];

    if (nc != 1 && nc != 3) {
        set_err("%s: only 1- or 3-channel DICOM write is supported",
                path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    if (nc == 3 && jpeg) {
        set_err("%s: JPEG-encapsulated RGB write is not supported", path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }

    // Pixel payload: scale to 8 bits by 255/max (write_dcm_cpp,
    // dicom.cpp:1712-1745); negative voxels are an error. RGB data is
    // pixel-interleaved ((z, y, x, c) C-order input = PlanarConfiguration
    // 0), PhotometricInterpretation "RGB" like the reference's declared
    // (but unreachable, dicom.cpp:1491-1495) color branch.
    const size_t n = (size_t)nx * ny * nz * nc;
    float im_max = max_val;
    if (im_max < 0.0f) {
        im_max = 0.0f;
        for (size_t i = 0; i < n; i++)
            im_max = std::max(im_max, std::fabs(data[i]));
    }
    const float scale = im_max == 0.0f ? 1.0f : 255.0f / im_max;
    std::vector<uint8_t> pix(n);
    for (size_t i = 0; i < n; i++) {
        if (data[i] < 0.0f) {
            set_err("%s: image cannot be negative", path);
            return S3D_FAILURE;
        }
        pix[i] = (uint8_t)(data[i] * scale);
    }

    std::string inst_uid = instance_uid && instance_uid[0]
        ? instance_uid : gen_uid();
    std::string ser_uid = series_uid && series_uid[0]
        ? series_uid : gen_uid();

    // File meta group
    Writer meta;
    uint8_t ver[2] = {0, 1};
    meta.element({0x0002, 0x0001}, "OB", ver, 2);
    meta.str({0x0002, 0x0002}, "UI", UID_CTImageStorage);
    meta.str({0x0002, 0x0003}, "UI", inst_uid);
    meta.str({0x0002, 0x0010}, "UI",
             jpeg ? UID_JPEGLosslessSV1 : UID_ExplicitLE);
    meta.str({0x0002, 0x0012}, "UI", UID_ROOT + std::string("1"));

    Writer w;
    w.str({0x0008, 0x0008}, "CS", "DERIVED");
    w.str(kSOPClassUID, "UI", UID_CTImageStorage);
    w.str(kSOPInstanceUID, "UI", inst_uid);
    w.str({0x0010, 0x0010}, "PN", "DefaultSIFT3DPatient");
    w.str({0x0010, 0x0020}, "LO", "DefaultSIFT3DPatientID");
    w.str({0x0020, 0x000D}, "UI", UID_ROOT + std::string("2"));
    w.str(kSeriesUID, "UI", ser_uid);
    w.str({0x0008, 0x103E}, "LO", "Series generated by SIFT3D");
    snprintf(buf, sizeof(buf), "%u", instance_num);
    w.str({0x0020, 0x0013}, "IS", buf);

    // Geometry, exactly as the reference writes it (dicom.cpp:1640-1706)
    const double posx = (double)(nx - 1) * ux;
    const double posy = (double)(ny - 1) * uy;
    const double posz = (double)instance_num * uz;
    snprintf(buf, sizeof(buf), "%f\\%f\\%f", posx, posy, posz);
    w.str(kImagePosition, "DS", buf);
    snprintf(buf, sizeof(buf), "%f\\%f\\%f\\%f\\%f\\%f", 1., 0., 0., 0., 1.,
             0.);
    w.str(kImageOrientation, "DS", buf);
    snprintf(buf, sizeof(buf), "%f", posz);
    w.str({0x0020, 0x1041}, "DS", buf);          // SliceLocation
    snprintf(buf, sizeof(buf), "%lf\\%lf", ux, uy);
    w.str(kPixelSpacing, "DS", buf);
    snprintf(buf, sizeof(buf), "%f", uz);
    w.str(kSliceThickness, "DS", buf);

    w.us(kSamplesPerPixel, (uint16_t)nc);
    w.str({0x0028, 0x0004}, "CS", nc == 3 ? "RGB" : "MONOCHROME2");
    w.us(kPlanarConfig, 0);                      // interleaved pixels
    snprintf(buf, sizeof(buf), "%d", nz);
    w.str(kNumberOfFrames, "IS", buf);
    w.us(kRows, (uint16_t)ny);
    w.us(kColumns, (uint16_t)nx);
    w.us(kBitsAllocated, 8);
    w.us({0x0028, 0x0101}, 8);                   // BitsStored
    w.us({0x0028, 0x0102}, 7);                   // HighBit
    w.us(kPixelRep, 0);
    if (jpeg) {
        // One lossless-SV1 stream per frame (what the reference emits
        // through DCMTK's EJ_JPEGLossless14SV1, dicom.cpp:1748).
        std::vector<std::vector<uint8_t>> frames;
        std::vector<uint16_t> s16((size_t)nx * ny);
        for (int z = 0; z < nz; z++) {
            const uint8_t *fp8 = pix.data() + (size_t)z * nx * ny;
            for (size_t i = 0; i < (size_t)nx * ny; i++) s16[i] = fp8[i];
            frames.push_back(jls_encode(s16.data(), nx, ny, 8));
        }
        w.encapsulated_pixels(frames);
    } else {
        w.element(kPixelData, "OB", pix.data(), pix.size());
    }

    // Group length for the meta group
    Writer hdr;
    uint32_t glen = (uint32_t)meta.out.size();
    hdr.w16(0x0002); hdr.w16(0x0000);
    hdr.raw("UL", 2); hdr.w16(4); hdr.w32(glen);

    FILE *fp = fopen(path, "wb");
    if (!fp) { set_err("cannot write %s", path); return S3D_FAILURE; }
    uint8_t preamble[128] = {0};
    fwrite(preamble, 1, 128, fp);
    fwrite("DICM", 1, 4, fp);
    fwrite(hdr.out.data(), 1, hdr.out.size(), fp);
    fwrite(meta.out.data(), 1, meta.out.size(), fp);
    fwrite(w.out.data(), 1, w.out.size(), fp);
    fclose(fp);
    return S3D_SUCCESS;
}

bool ends_with_dcm(const std::string &s) {
    if (s.size() < 4) return false;
    std::string e = s.substr(s.size() - 4);
    for (auto &c : e) c = (char)tolower(c);
    return e == ".dcm";
}

struct DirSlice {
    std::string path;
    DcmFile f;
    Geometry g;
};

int scan_dir(const char *dirpath, std::vector<DirSlice> &slices) {
    struct stat st;
    if (stat(dirpath, &st)) {
        set_err("cannot find %s", dirpath);
        return S3D_FILE_DOES_NOT_EXIST;
    }
    if (!S_ISDIR(st.st_mode)) {
        set_err("%s is not a directory", dirpath);
        return S3D_FAILURE;
    }
    DIR *dir = opendir(dirpath);
    if (!dir) { set_err("cannot open %s", dirpath); return S3D_FAILURE; }
    struct dirent *ent;
    while ((ent = readdir(dir)) != NULL) {
        std::string full = std::string(dirpath) + "/" + ent->d_name;
        if (!ends_with_dcm(full)) continue;
        DirSlice s;
        s.path = full;
        int ret = parse_file(full.c_str(), s.f, false);
        if (ret != S3D_SUCCESS) { closedir(dir); return ret; }
        if (s.f.sop_class == UID_DSO) continue;   // ignore DSOs
        ret = compute_geometry(s.f, s.g, full.c_str());
        if (ret != S3D_SUCCESS) { closedir(dir); return ret; }
        slices.push_back(std::move(s));
    }
    closedir(dir);
    if (slices.empty()) {
        set_err("no DICOM files found in %s", dirpath);
        return S3D_FAILURE;
    }
    std::sort(slices.begin(), slices.end(),
              [](const DirSlice &a, const DirSlice &b) {
                  return a.g.sort_coord < b.g.sort_coord;
              });
    return S3D_SUCCESS;
}

// Series validation + output geometry (dcm_resize_im, dicom.cpp:1219-1366)
int dir_geometry(const std::vector<DirSlice> &slices, int dims[3],
                 double units[3]) {
    const DirSlice &first = slices[0];
    const int sort_axis = first.g.sort_axis;
    for (size_t i = 1; i < slices.size(); i++) {
        if (slices[i].f.series_uid != first.f.series_uid) {
            set_err("%s is from a different series than %s",
                    slices[i].path.c_str(), first.path.c_str());
            return S3D_FAILURE;
        }
        if (slices[i].g.sort_axis != sort_axis) {
            set_err("%s is sorted by a different axis than %s",
                    slices[i].path.c_str(), first.path.c_str());
            return S3D_INCONSISTENT_AXES;
        }
    }
    for (int k = 0; k < 3; k++) units[k] = first.g.units[k];

    if (slices.size() > 1) {
        const double tol = 5e-2;
        const double first_spacing =
            std::fabs(first.g.sort_coord - slices[1].g.sort_coord);
        for (size_t i = 0; i + 1 < slices.size(); i++) {
            const double spacing = std::fabs(
                slices[i].g.sort_coord - slices[i + 1].g.sort_coord);
            if (spacing == 0.0) {
                set_err("%s and %s have duplicate slice coordinates",
                        slices[i].path.c_str(), slices[i + 1].path.c_str());
                return S3D_DUPLICATE_SLICES;
            }
            if (std::fabs(spacing - first_spacing) > tol) {
                set_err("%s and %s do not follow the series spacing",
                        slices[i].path.c_str(), slices[i + 1].path.c_str());
                return S3D_UNEVEN_SPACING;
            }
        }
        units[sort_axis] = first_spacing;
    }

    int d[3] = {first.f.cols, first.f.rows, first.f.frames};
    int n_slice = 0;
    for (const auto &s : slices) {
        int sd[3] = {s.f.cols, s.f.rows, s.f.frames};
        for (int axis = 0; axis < 3; axis++) {
            // Every non-sorting dim must agree - including the frames
            // axis when the series is x/y-sorted, so query and read
            // agree on which series are valid.
            if (axis == sort_axis) continue;
            if (sd[axis] != d[axis]) {
                set_err("%s has mismatched dimensions vs %s",
                        s.path.c_str(), first.path.c_str());
                return S3D_FAILURE;
            }
        }
        n_slice += sd[sort_axis];
    }
    d[sort_axis] = n_slice;
    for (int k = 0; k < 3; k++) dims[k] = d[k];
    return S3D_SUCCESS;
}

} // namespace

extern "C" {

const char *s3d_dcm_last_error(void) { return g_err; }

/* Query a single DICOM file: dims4 = {nx, ny, nz, nc}; units3 (mm). */
int s3d_dcm_query(const char *path, int *dims4, double *units3) {
    DcmFile f;
    int ret = parse_file(path, f, false);
    if (ret != S3D_SUCCESS) return ret;
    Geometry g;
    ret = compute_geometry(f, g, path);
    if (ret != S3D_SUCCESS) return ret;
    dims4[0] = f.cols; dims4[1] = f.rows; dims4[2] = f.frames;
    dims4[3] = out_nc(f);
    for (int k = 0; k < 3; k++) units3[k] = g.units[k];
    return S3D_SUCCESS;
}

/* Read a single DICOM file into out (nz, ny, nx) float32 C-order. */
int s3d_dcm_read(const char *path, float *out) {
    DcmFile f;
    int ret = parse_file(path, f, true);
    if (ret != S3D_SUCCESS) return ret;
    Geometry g;
    ret = compute_geometry(f, g, path);
    if (ret != S3D_SUCCESS) return ret;
    return copy_pixels(f, g, out, path);
}

/* Query a DICOM directory. */
int s3d_dcm_dir_query(const char *dirpath, int *dims4, double *units3) {
    std::vector<DirSlice> slices;
    int ret = scan_dir(dirpath, slices);
    if (ret != S3D_SUCCESS) return ret;
    int d[3]; double u[3];
    ret = dir_geometry(slices, d, u);
    if (ret != S3D_SUCCESS) return ret;
    dims4[0] = d[0]; dims4[1] = d[1]; dims4[2] = d[2];
    dims4[3] = out_nc(slices[0].f);
    for (int k = 0; k < 3; k++) units3[k] = u[k];
    return S3D_SUCCESS;
}

/* Read a DICOM directory into out (nz, ny, nx) float32, slices stacked
 * along the sorting axis in coordinate order. */
int s3d_dcm_dir_read(const char *dirpath, float *out) {
    std::vector<DirSlice> slices;
    int ret = scan_dir(dirpath, slices);
    if (ret != S3D_SUCCESS) return ret;
    int d[3]; double u[3];
    ret = dir_geometry(slices, d, u);
    if (ret != S3D_SUCCESS) return ret;
    const int sort_axis = slices[0].g.sort_axis;
    if (sort_axis != 2) {
        // The reference stacks along any axis via write_subvolume; only
        // z-stacking is implemented here (x/y-sorted series are rare).
        set_err("only z-sorted DICOM series are supported (sort axis %s)",
                sort_axis == 0 ? "x" : "y");
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    const int nc0 = out_nc(slices[0].f);
    size_t plane = (size_t)d[0] * d[1] * nc0;
    size_t off = 0;
    for (auto &s : slices) {
        DcmFile f;
        ret = parse_file(s.path.c_str(), f, true);
        if (ret != S3D_SUCCESS) return ret;
        if (out_nc(f) != nc0) {
            // The reference rejects mixed channel counts the same way
            // (read_directory_cpp, dicom.cpp:1328-1335).
            set_err("%s: slice channel count differs from the series",
                    s.path.c_str());
            return S3D_FAILURE;
        }
        ret = copy_pixels(f, s.g, out + off, s.path.c_str());
        if (ret != S3D_SUCCESS) return ret;
        off += plane * f.frames;
    }
    return S3D_SUCCESS;
}

/* Read a single-segment DICOM Segmentation Object (DSO) into the
 * geometry of its referenced image directory (reference read_dso,
 * dicom.cpp:1012-1149): the DSO's binary frames are matched to the
 * sorted image slices by ReferencedSOPInstanceUID; unmatched slices
 * stay zero. out must hold the directory's (nz, ny, nx) floats. */
int s3d_dcm_dso_read(const char *dso_path, const char *im_dir,
                     float *out) {
    DcmFile f;
    int ret = parse_file(dso_path, f, true);
    if (ret != S3D_SUCCESS) return ret;
    if (f.sop_class != UID_DSO) {
        set_err("%s: not a DICOM Segmentation Object", dso_path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    if (f.n_segments != 1) {
        set_err("%s: only single-segment DSOs are supported", dso_path);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    if ((int)f.ref_instance_uids.size() != f.frames) {
        set_err("%s: DSO frame count does not match its referenced "
                "instance count", dso_path);
        return S3D_FAILURE;
    }
    std::vector<DirSlice> slices;
    ret = scan_dir(im_dir, slices);
    if (ret != S3D_SUCCESS) return ret;
    int d[3]; double u[3];
    ret = dir_geometry(slices, d, u);
    if (ret != S3D_SUCCESS) return ret;
    if (slices[0].g.sort_axis != 2) {
        set_err("%s: only z-sorted referenced series are supported",
                im_dir);
        return S3D_UNSUPPORTED_FILE_TYPE;
    }
    if (f.cols != d[0] || f.rows != d[1]) {
        set_err("%s: DSO frame dims do not match the referenced series",
                dso_path);
        return S3D_FAILURE;
    }
    // Decode the DSO's own frames (binary 1-bit or 8-bit) with default
    // axes; segmentation rescale/PET paths do not apply.
    Geometry g;
    std::vector<float> tmp((size_t)f.cols * f.rows * f.frames);
    ret = copy_pixels(f, g, tmp.data(), dso_path);
    if (ret != S3D_SUCCESS) return ret;

    const size_t plane = (size_t)d[0] * d[1];
    memset(out, 0, plane * (size_t)d[2] * sizeof(float));
    for (int k = 0; k < f.frames; k++) {
        const std::string &uid = f.ref_instance_uids[k];
        int m = -1;
        for (size_t s = 0; s < slices.size(); s++)
            if (slices[s].f.sop_instance == uid) { m = (int)s; break; }
        if (m < 0) {
            set_err("%s: no image found with referenced SOPInstanceUID %s",
                    dso_path, uid.c_str());
            return S3D_FAILURE;
        }
        memcpy(out + (size_t)m * plane, tmp.data() + (size_t)k * plane,
               plane * sizeof(float));
    }
    return S3D_SUCCESS;
}

/* Write a single multi-frame 8-bit DICOM file; data is (nz, ny, nx, nc)
 * C-order (nc 1 = MONOCHROME2, 3 = interleaved RGB). series_uid may be
 * NULL or empty (a fresh UID is generated); instance_num defaults to 1
 * when <= 0. */
int s3d_dcm_write(const char *path, const float *data, int nx, int ny,
                  int nz, int nc, double ux, double uy, double uz,
                  const char *series_uid, int instance_num) {
    return write_single(path, data, nx, ny, nz, ux, uy, uz,
                        instance_num > 0 ? (unsigned)instance_num : 1u,
                        series_uid ? series_uid : "", "", -1.0f, false,
                        nc);
}

int s3d_dcm_write_jpegls(const char *path, const float *data, int nx,
                         int ny, int nz, int nc, double ux, double uy,
                         double uz, const char *series_uid,
                         int instance_num) {
    g_err[0] = 0;
    return write_single(path, data, nx, ny, nz, ux, uy, uz,
                        instance_num > 0 ? (unsigned)instance_num : 1u,
                        series_uid ? series_uid : "", "", -1.0f, true,
                        nc);
}

/* Write a directory of single-slice DICOM files (%0Nd.dcm); data is
 * (nz, ny, nx, nc) C-order. */
int s3d_dcm_write_dir(const char *dirpath, const float *data, int nx,
                      int ny, int nz, int nc, double ux, double uy,
                      double uz) {
    struct stat st;
    if (stat(dirpath, &st)) {
        if (mkdir(dirpath, 0777)) {
            set_err("cannot create directory %s", dirpath);
            return S3D_FAILURE;
        }
    }
    float max_val = 0.0f;
    size_t n = (size_t)nx * ny * nz * nc;
    for (size_t i = 0; i < n; i++)
        max_val = std::max(max_val, std::fabs(data[i]));

    int num_zeros = (int)std::ceil(std::log10((double)std::max(nz, 2)));
    std::string series = gen_uid();
    for (int i = 0; i < nz; i++) {
        char name[64];
        snprintf(name, sizeof(name), "%0*d.dcm", num_zeros, i);
        std::string full = std::string(dirpath) + "/" + name;
        int ret = write_single(full.c_str(),
                               data + (size_t)i * nx * ny * nc,
                               nx, ny, 1, ux, uy, uz,
                               (unsigned)(i + 1), series.c_str(),
                               gen_uid().c_str(), max_val, false, nc);
        if (ret != S3D_SUCCESS) return ret;
    }
    return S3D_SUCCESS;
}

} // extern "C"
