/*
 * ec_oracle.c — encode a fixed LCG-driven symbol stream with the reference
 * entropy encoder (aom_dsp/entenc.c) and dump the bytes, so the Python/C++
 * range coder can be validated byte-exactly (tests/test_ec.py).
 *
 * Build: gcc tools/ec_oracle.c -I$REF -I$REFBUILD $REFBUILD/libaom.a -lm
 */
#include <stdio.h>
#include <stdint.h>
#include <string.h>

#include "config/aom_config.h"
#include "aom_dsp/entenc.h"
#include "aom_dsp/prob.h"

static uint32_t state = 0x12345678;
static uint32_t lcg(void) {
  state = state * 1103515245u + 12345u;
  return state >> 16;
}

int main(int argc, char **argv) {
  od_ec_enc enc;
  od_ec_enc_init(&enc, 1 << 20);

  static aom_cdf_prob cdfs[64][17][17];
  static int have[64][17];
  memset(have, 0, sizeof(have));

  for (int i = 0; i < 20000; i++) {
    int nsyms = 2 + lcg() % 15;
    int key = lcg() % 64;
    if (!have[key][nsyms]) {
      for (int j = 0; j < nsyms - 1; j++)
        cdfs[key][nsyms][j] =
            (aom_cdf_prob)(32768 - (32768 * (j + 1) / nsyms));
      cdfs[key][nsyms][nsyms - 1] = 0;
      cdfs[key][nsyms][nsyms] = 0;
      have[key][nsyms] = 1;
    }
    aom_cdf_prob *icdf = cdfs[key][nsyms];
    int s = lcg() % nsyms;
    od_ec_encode_cdf_q15(&enc, s, icdf, nsyms);
    update_cdf(icdf, s, nsyms);
    if (i % 7 == 0) {
      int v = lcg() & 0xFF;
      for (int b = 7; b >= 0; b--) {
        int p = (0x7FFFFF - (128 << 15) + 128) >> 8;
        od_ec_encode_bool_q15(&enc, (v >> b) & 1, p);
      }
    }
  }
  uint32_t nbytes;
  unsigned char *out = od_ec_enc_done(&enc, &nbytes);
  FILE *f = fopen(argc > 1 ? argv[1] : "ec_oracle.bin", "wb");
  fwrite(out, 1, nbytes, f);
  fclose(f);
  fprintf(stderr, "wrote %u bytes\n", nbytes);
  od_ec_enc_clear(&enc);
  return 0;
}
