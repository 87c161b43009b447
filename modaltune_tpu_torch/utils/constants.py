"""Dataset/task constants (mirrors ``utils/constants.py`` in the
reference: TCGA project groupings, task ids, pan-cancer site labels)."""

# combined cancer types -> constituent TCGA projects
PROJECT_ID_MAP = {
    "TCGA-BLCA": ["TCGA-BLCA"],
    "TCGA-BRCA": ["TCGA-BRCA"],
    "TCGA-COADREAD": ["TCGA-COAD", "TCGA-READ"],
    "TCGA-GBMLGG": ["TCGA-GBM", "TCGA-LGG"],
    "TCGA-NSCLC": ["TCGA-LUAD", "TCGA-LUSC"],
    "TCGA-RCC": ["TCGA-KICH", "TCGA-KIRC", "TCGA-KIRP"],
    "TCGA-UCEC": ["TCGA-UCEC"],
}

TASK_IDS = {0: "General", 1: "Diagnosis", 2: "Survival"}

NUM_SITES = 4

SITE_LABEL = {
    "TCGA-BRCA": 0,
    "TCGA-GBM": 1,
    "TCGA-LGG": 1,
    "TCGA-LUAD": 2,
    "TCGA-LUSC": 2,
    "TCGA-KICH": 3,
    "TCGA-KIRC": 3,
    "TCGA-KIRP": 3,
}

# per-site subtype class counts for the pan-cancer run
# (train_modaltune_pancancer.py num_classes "2,2,2,3")
PANCANCER_NUM_CLASSES = (2, 2, 2, 3)
