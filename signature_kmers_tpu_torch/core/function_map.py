"""Function metadata constants used by the calling path."""

UNDEFINED_FUNCTION = 0xFFFF  # ref: kmer_data.h:23
