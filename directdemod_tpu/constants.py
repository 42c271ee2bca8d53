"""Tunables and protocol constants for the software-radio framework.

Numeric values mirror the reference semantics (reference `directdemod/constants.py:1-40`)
so decoded outputs are comparable; layout and naming are our own.
"""

# ---------------------------------------------------------------- IQ capture defaults
IQ_FREQOFFSET = 30_000          # default channel offset in Hz (ref constants.py:4)
IQ_SDRSAMPRATE = 2_048_000      # default SDR sample rate in Hz (ref constants.py:5)

# ---------------------------------------------------------------- stream processing
PROC_CHUNKSIZE = 20_000_000     # samples per stream block (ref constants.py:8).
                                # Chunk boundaries are part of the numeric contract:
                                # strict resample + Hilbert are applied per block.

# ---------------------------------------------------------------- NOAA APT protocol
NOAA_FMBW = 60_000              # FM bandwidth target before demod (ref constants.py:11)
NOAA_AUDSAMPRATE = 20_800       # audio output rate (ref constants.py:12)
NOAA_FREQ = 137_620_000
NOAA_CRUDESYNCSAMPRATE = 40_960  # requested crude-sync rate; the effective rate after
                                 # integer-stride decimation is int(2048000/34) = 60235 Hz
NOAA_T = 1.0 / 4160             # seconds per APT "bit" (word) (ref constants.py:15)

# 40-word sync trains preceding channel A / channel B lines (ref constants.py:16-17)
NOAA_SYNCA = (0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0,
              1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
NOAA_SYNCB = (0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1,
              1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0)

NOAA_PEAKHEIGHTWIGGLE = 0.25    # allowed fractional drop below mean peak height
NOAA_MINPEAKDIST = 0.45         # minimum sync spacing in seconds
NOAA_COLORCORRECT_FIFOLEN = 10_000
NOAA_DETECTMAXCHANGE = 5        # max jitter (samples) for the usefulness test
NOAA_DETECTCONSSYNCSNUM = 10    # consecutive syncs required for usefulness
NOAA_SATS = {137_620_000: "NOAA 15", 137_100_000: "NOAA 19", 137_912_500: "NOAA 18"}

# ---------------------------------------------------------------- source kinds
SOURCE_IQWAV = 0
SOURCE_IQDAT = 1

# ---------------------------------------------------------------- filter kinds
FLT_LP = 0
FLT_HP = 1
FLT_BP = 2
FLT_BS = 3

# ---------------------------------------------------------------- AFSK1200 / APRS
AFSK_BAUDRATE = 1200
AFSK_MARK_HZ = 1200
AFSK_SPACE_HZ = 2200
AFSK_DEFAULT_BW = 22_050

# ---------------------------------------------------------------- Funcube BPSK
FUNCUBE_SYMRATE = 12_000
FUNCUBE_DEFAULT_BW = 7_000
FUNCUBE_SYNC_BITS = "101000110001000000000001010111100"  # 33-bit frame sync
FUNCUBE_FRAME_SPACING_S = 4.98

# ---------------------------------------------------------------- Meteor-M2 QPSK
METEOR_SYMRATE = 72_000
METEOR_DEFAULT_BW = 70_000
METEOR_FRAME_SPACING_S = 0.11
