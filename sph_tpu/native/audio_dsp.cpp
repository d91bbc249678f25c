// Native band-split + envelope DSP core (C ABI, loaded via ctypes).
//
// Rebuild of the reference's shared audio DSP
// (ComponentFramework/AudioBands.h:44-58 ProcessSample,
//  ComponentFramework/ReelExport.cpp:101-149 AnalyzeTrack inner loop):
// one-pole band split (bass = LP 150 Hz; mid = LP 2 kHz then HP 250 Hz;
// treble = HP 2.8 kHz) and attack/release peak-envelope followers, run
// per sample with envelope state carried continuously across frames.
// The per-sample recurrence is inherently sequential, so it lives here
// in C++ rather than in vectorized numpy; sph_tpu/audio/bands.py holds
// a lax.scan fallback with identical semantics for environments without
// a compiler.
//
// Build: g++ -O2 -shared -fPIC audio_dsp.cpp -o _audio_dsp.so
#include <cmath>
#include <cstdint>

namespace {

inline float filter_alpha(float fc_hz, float fs_hz) {
    return 1.0f - std::exp(-6.2831853f * fc_hz / fs_hz);
}

inline float envelope_coeff(float tc_ms, float fs_hz) {
    float tc = tc_ms > 0.1f ? tc_ms : 0.1f;
    return 1.0f - std::exp(-1000.0f / (tc * fs_hz));
}

struct BandState {
    float lp_bass = 0.0f, lp_mid_hi = 0.0f, lp_mid_lo = 0.0f,
          lp_treble = 0.0f;
    float env_bass = 0.0f, env_mid = 0.0f, env_treble = 0.0f;
};

inline void process_sample(float mono, BandState& s, float a_bass,
                           float a_mid_hi, float a_mid_lo, float a_treble,
                           float attack, float release) {
    s.lp_bass += a_bass * (mono - s.lp_bass);
    s.lp_mid_hi += a_mid_hi * (mono - s.lp_mid_hi);
    s.lp_mid_lo += a_mid_lo * (s.lp_mid_hi - s.lp_mid_lo);
    float mid = s.lp_mid_hi - s.lp_mid_lo;
    s.lp_treble += a_treble * (mono - s.lp_treble);
    float treble = mono - s.lp_treble;

    float rb = std::fabs(s.lp_bass);
    float rm = std::fabs(mid);
    float rt = std::fabs(treble);
    s.env_bass += ((rb > s.env_bass) ? attack : release) * (rb - s.env_bass);
    s.env_mid += ((rm > s.env_mid) ? attack : release) * (rm - s.env_mid);
    s.env_treble +=
        ((rt > s.env_treble) ? attack : release) * (rt - s.env_treble);
}

}  // namespace

extern "C" {

// Run the full per-frame analysis: process mono samples up to each
// frame_ends[f] boundary, then sample the three envelopes (clamped to
// env_clamp, reference clamps to 4.0 at AudioReactive.cpp:150-154 and
// ReelExport.cpp:143-145).  state_io is 7 floats (BandState) carried
// in/out so callers can stream.
void sph_audio_analyze(const float* mono, int64_t n_samples,
                       const int64_t* frame_ends, int64_t n_frames,
                       float fs, float attack_ms, float release_ms,
                       float env_clamp, float* state_io, float* out_bass,
                       float* out_mid, float* out_treble) {
    const float a_bass = filter_alpha(150.0f, fs);
    const float a_mid_hi = filter_alpha(2000.0f, fs);
    const float a_mid_lo = filter_alpha(250.0f, fs);
    const float a_treble = filter_alpha(2800.0f, fs);
    const float attack = envelope_coeff(attack_ms, fs);
    const float release = envelope_coeff(release_ms, fs);

    BandState s;
    s.lp_bass = state_io[0];
    s.lp_mid_hi = state_io[1];
    s.lp_mid_lo = state_io[2];
    s.lp_treble = state_io[3];
    s.env_bass = state_io[4];
    s.env_mid = state_io[5];
    s.env_treble = state_io[6];

    int64_t i = 0;
    for (int64_t f = 0; f < n_frames; ++f) {
        int64_t end = frame_ends[f];
        if (end > n_samples) end = n_samples;
        for (; i < end; ++i) {
            process_sample(mono[i], s, a_bass, a_mid_hi, a_mid_lo, a_treble,
                           attack, release);
        }
        out_bass[f] = s.env_bass < env_clamp ? s.env_bass : env_clamp;
        out_mid[f] = s.env_mid < env_clamp ? s.env_mid : env_clamp;
        out_treble[f] = s.env_treble < env_clamp ? s.env_treble : env_clamp;
    }

    state_io[0] = s.lp_bass;
    state_io[1] = s.lp_mid_hi;
    state_io[2] = s.lp_mid_lo;
    state_io[3] = s.lp_treble;
    state_io[4] = s.env_bass;
    state_io[5] = s.env_mid;
    state_io[6] = s.env_treble;
}

}  // extern "C"
