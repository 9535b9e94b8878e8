"""Appearance-flag bit positions of the posting bitfield (column F_FLAGS).

Copy of the constants in yacy_search_server_tpu/utils/bitfield.py, whose
positions follow the reference (document/Tokenizer.java:51-56 and
kelondro/data/word/WordReferenceRow.java:104-110) so ranking semantics
match across both packages.
"""

from __future__ import annotations

# category flags
FLAG_CAT_INDEXOF = 0
FLAG_CAT_HASIMAGE = 20
FLAG_CAT_HASAUDIO = 21
FLAG_CAT_HASVIDEO = 22
FLAG_CAT_HASAPP = 23

# appearance flags
FLAG_APP_DC_DESCRIPTION = 24
FLAG_APP_DC_TITLE = 25
FLAG_APP_DC_CREATOR = 26
FLAG_APP_DC_SUBJECT = 27
FLAG_APP_DC_IDENTIFIER = 28
FLAG_APP_EMPHASIZED = 29
