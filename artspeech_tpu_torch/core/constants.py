"""Articulator name constants, plot colors, special tokens and phase names
(copy of artspeech_tpu/core/constants.py).

Replaces the external ``vt_tools`` constants surface used throughout the
reference (see reference tract_variables.py:3-10, scripts/shape_to_air_column.py:7-19)
and reference settings.py:3-9.
"""

# --- Special tokens (reference settings.py:3-5) ---
SIL = "#"
UNKNOWN = "<unk>"
BLANK = "<blank>"

# --- Phase names (reference settings.py:7-9) ---
TRAIN = "train"
VALID = "validation"
TEST = "test"

# --- Articulator names (kebab-case, vt_tools constants) ---
ARYTENOID_CARTILAGE = "arytenoid-cartilage"
EPIGLOTTIS = "epiglottis"
LOWER_INCISOR = "lower-incisor"
LOWER_LIP = "lower-lip"
PHARYNX = "pharynx"
SOFT_PALATE = "soft-palate"
SOFT_PALATE_MIDLINE = "soft-palate-midline"
THYROID_CARTILAGE = "thyroid-cartilage"
TONGUE = "tongue"
UPPER_INCISOR = "upper-incisor"
UPPER_LIP = "upper-lip"
VOCAL_FOLDS = "vocal-folds"

#: The 11 articulators that define the vocal-tract tube (reference
#: scripts/shape_to_air_column.py:25-37). ``sorted(COLORS.keys())`` must equal
#: this list (reference generate_vocal_tract_shape.py:207 uses it that way).
TUBE_ARTICULATORS = [
    ARYTENOID_CARTILAGE,
    EPIGLOTTIS,
    LOWER_INCISOR,
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    THYROID_CARTILAGE,
    TONGUE,
    UPPER_INCISOR,
    UPPER_LIP,
    VOCAL_FOLDS,
]

#: Articulator -> plot color (vt_tools COLORS equivalent).
COLORS = {
    ARYTENOID_CARTILAGE: "tab:cyan",
    EPIGLOTTIS: "tab:purple",
    LOWER_INCISOR: "tab:gray",
    LOWER_LIP: "tab:red",
    PHARYNX: "tab:olive",
    SOFT_PALATE_MIDLINE: "tab:pink",
    THYROID_CARTILAGE: "tab:brown",
    TONGUE: "tab:blue",
    UPPER_INCISOR: "tab:green",
    UPPER_LIP: "tab:orange",
    VOCAL_FOLDS: "black",
}

#: Articulators required to compute tract variables (reference
#: phoneme_to_articulation/__init__.py:37-44).
REQUIRED_ARTICULATORS_FOR_TVS = [
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    TONGUE,
    UPPER_LIP,
    UPPER_INCISOR,
]

#: Phoneme groups for recognizer confusion analysis (reference
#: phoneme_recognition/__init__.py:24-43).
CLASSES_NAMES = {
    0: "dental",
    1: "labial",
    2: "palatal",
    3: "front vowels",
    4: "back vowels",
    5: "open vowels",
    6: "rounded vowels",
    7: "other",
}

PHONETIC_CLASSES = {
    0: ["t", "d", "n", "l", "z", "s"],
    1: ["p", "b", "m", "f", "v"],
    2: ["k", "g", "Z", "S"],
    3: ["i", "e", "E", "E/", "U~/", "j"],
    4: ["u", "o", "O", "O/", "o~", "w"],
    5: ["a", "a~"],
    6: ["y", "2", "9", "H"],
}

#: The 10 articulators fed to the recognizer's vocal-tract feature
#: (reference phoneme_recognition/datasets.py:33-44 — TUBE_ARTICULATORS
#: minus the upper incisor, which is the coordinate-system reference).
RECOGNITION_ARTICULATORS = [
    ARYTENOID_CARTILAGE,
    EPIGLOTTIS,
    LOWER_INCISOR,
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    THYROID_CARTILAGE,
    TONGUE,
    UPPER_LIP,
    VOCAL_FOLDS,
]
