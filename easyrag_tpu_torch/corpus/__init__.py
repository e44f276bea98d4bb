"""Host-side corpus layer: reading, chunking, metadata, content views."""

from .views import get_node_content, merge_strings  # noqa: F401
from .reader import read_data  # noqa: F401
from .splitter import SentenceSplitter  # noqa: F401
from .hierarchical import (  # noqa: F401
    HierarchicalSplitter,
    get_leaf_nodes,
    get_root_nodes,
)
from .extractors import (  # noqa: F401
    extract_titles,
    extract_file_paths,
    filter_image,
    run_extractors,
)
from .tokenizer import (  # noqa: F401
    JiebaTokenizer,
    load_stopwords,
    default_stopwords,
    tokenize_and_remove_stopwords,
)
