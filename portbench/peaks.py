"""Published peaks of the card the benchmark's rooflines are read against:
one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W
power limit; a card set below it runs slower under load, so a run reports
its card's name beside every share)."""

HBM_BYTES_PER_S = 3.35e12  # K1's operations (about ten a pixel) take a tenth of
# its bytes' time at the card's 67 TFLOP/s in float32, so bytes bound it
