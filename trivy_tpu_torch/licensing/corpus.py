"""License fingerprint corpus: a verbatim data copy of the JAX package's
``licensing/corpus.py`` (the tests hold the two equal).

Distinctive phrases per SPDX license id, written against the public license
texts (the reference wraps google/licenseclassifier's n-gram corpus,
ref: pkg/licensing/classifier.go). Phrases are matched on normalized text
(lowercased, whitespace collapsed) and chosen to be (a) unique enough that
a match strongly implies the license, (b) short enough to survive line
rewrapping after normalization. Confidence = fraction of phrases present.
"""

NORMALIZED_FINGERPRINTS: dict[str, list[str]] = {
    "MIT": [
        "permission is hereby granted, free of charge, to any person obtaining a copy",
        "the software is provided \"as is\", without warranty of any kind",
        "the above copyright notice and this permission notice shall be included",
    ],
    "Apache-2.0": [
        "apache license",
        "version 2.0, january 2004",
        "licensed under the apache license, version 2.0",
        "unless required by applicable law or agreed to in writing",
    ],
    "GPL-2.0-only": [
        "gnu general public license",
        "version 2, june 1991",
        "this program is free software; you can redistribute it and/or modify",
    ],
    "GPL-3.0-only": [
        "gnu general public license",
        "version 3, 29 june 2007",
        "this program is free software: you can redistribute it and/or modify",
    ],
    "LGPL-2.1-only": [
        "gnu lesser general public license",
        "version 2.1, february 1999",
    ],
    "LGPL-3.0-only": [
        "gnu lesser general public license",
        "version 3, 29 june 2007",
    ],
    "AGPL-3.0-only": [
        "gnu affero general public license",
        "version 3, 19 november 2007",
    ],
    "BSD-2-Clause": [
        "redistribution and use in source and binary forms",
        "redistributions of source code must retain the above copyright notice",
        "redistributions in binary form must reproduce the above copyright",
    ],
    "BSD-3-Clause": [
        "redistribution and use in source and binary forms",
        "neither the name of",
        "may be used to endorse or promote products derived from this software",
    ],
    "ISC": [
        "permission to use, copy, modify, and/or distribute this software for any purpose",
        "the software is provided \"as is\" and the author disclaims all warranties",
    ],
    "MPL-2.0": [
        "mozilla public license version 2.0",
        "this source code form is subject to the terms of the mozilla public",
    ],
    "EPL-2.0": [
        "eclipse public license - v 2.0",
        "this program and the accompanying materials are made available under the",
    ],
    "EPL-1.0": [
        "eclipse public license - v 1.0",
    ],
    "Unlicense": [
        "this is free and unencumbered software released into the public domain",
        "anyone is free to copy, modify, publish, use, compile, sell, or distribute",
    ],
    "CC0-1.0": [
        "cc0 1.0 universal",
        "creative commons",
        "no copyright",
    ],
    "CC-BY-4.0": [
        "creative commons attribution 4.0 international",
    ],
    "CC-BY-SA-4.0": [
        "creative commons attribution-sharealike 4.0 international",
    ],
    "CC-BY-NC-4.0": [
        "creative commons attribution-noncommercial 4.0 international",
    ],
    "WTFPL": [
        "do what the fuck you want to public license",
    ],
    "Zlib": [
        "this software is provided 'as-is', without any express or implied warranty",
        "altered source versions must be plainly marked as such",
    ],
    "BSL-1.0": [
        "boost software license - version 1.0",
    ],
    "PostgreSQL": [
        "postgresql license",
        "permission to use, copy, modify, and distribute this software and its documentation",
    ],
    "Artistic-2.0": [
        "the artistic license 2.0",
    ],
    "OpenSSL": [
        "openssl license",
        "this product includes software developed by the openssl project",
    ],
    "Python-2.0": [
        "python software foundation license version 2",
    ],
    "Ruby": [
        "you may make and give away verbatim copies of the source form of the software",
    ],
    "MIT-0": [
        "mit no attribution",
        "permission is hereby granted, free of charge, to any person obtaining a copy",
    ],
    "0BSD": [
        "permission to use, copy, modify, and/or distribute this software for any purpose with or without fee",
    ],
    # ----- GNU family versions --------------------------------------------
    "GPL-1.0-only": [
        "gnu general public license",
        "version 1, february 1989",
    ],
    "LGPL-2.0-only": [
        "gnu library general public license",
        "version 2, june 1991",
    ],
    "AGPL-1.0-only": [
        "affero general public license",
        "version 1, march 2002",
    ],
    "GFDL-1.1-only": [
        "gnu free documentation license",
        "version 1.1, march 2000",
    ],
    "GFDL-1.2-only": [
        "gnu free documentation license",
        "version 1.2, november 2002",
    ],
    "GFDL-1.3-only": [
        "gnu free documentation license",
        "version 1.3, 3 november 2008",
    ],
    # ----- Apache / BSD variants ------------------------------------------
    "Apache-1.1": [
        "the apache software license, version 1.1",
        "this product includes software developed by the apache software foundation",
    ],
    "Apache-1.0": [
        "redistribution and use in source and binary forms, with or without modification, are permitted provided",
        "this product includes software developed by the apache group",
    ],
    "BSD-4-Clause": [
        "all advertising materials mentioning features or use of this software",
        "must display the following acknowledgement",
        "redistribution and use in source and binary forms",
    ],
    "BSD-3-Clause-Clear": [
        "the clear bsd license",
        "no express or implied licenses to any party's patent rights are granted",
    ],
    # ----- Mozilla lineage -------------------------------------------------
    "MPL-1.1": [
        "mozilla public license version 1.1",
        "the contents of this file are subject to the mozilla public license",
    ],
    "MPL-1.0": [
        "mozilla public license version 1.0",
    ],
    "NPL-1.1": [
        "netscape public license version 1.1",
    ],
    "CDDL-1.0": [
        "common development and distribution license (cddl) version 1.0",
    ],
    "CDDL-1.1": [
        "common development and distribution license (cddl) version 1.1",
    ],
    # ----- corporate / foundation licenses --------------------------------
    "MS-PL": [
        "microsoft public license (ms-pl)",
        "this license governs use of the accompanying software",
    ],
    "MS-RL": [
        "microsoft reciprocal license (ms-rl)",
    ],
    "CPL-1.0": [
        "common public license version 1.0",
    ],
    "IPL-1.0": [
        "ibm public license version 1.0",
    ],
    "SPL-1.0": [
        "sun public license version 1.0",
    ],
    "APSL-2.0": [
        "apple public source license",
        "version 2.0",
    ],
    "QPL-1.0": [
        "the q public license",
        "version 1.0",
    ],
    "Intel": [
        "intel open source license",
    ],
    "Watcom-1.0": [
        "sybase open watcom public license",
    ],
    "RPSL-1.0": [
        "realnetworks public source license",
    ],
    "CPAL-1.0": [
        "common public attribution license version 1.0",
    ],
    "EUPL-1.1": [
        "european union public licence v. 1.1",
    ],
    "EUPL-1.2": [
        "european union public licence v. 1.2",
    ],
    "OSL-3.0": [
        "open software license v. 3.0",
        "licensed under the open software license version 3.0",
    ],
    "AFL-3.0": [
        "academic free license (\"afl\") v. 3.0",
    ],
    "ECL-2.0": [
        "educational community license, version 2.0",
    ],
    "EFL-2.0": [
        "eiffel forum license, version 2",
    ],
    "LPPL-1.3c": [
        "latex project public license",
        "lppl version 1.3c",
    ],
    "ODbL-1.0": [
        "open database license (odbl)",
        "open data commons open database license",
    ],
    "OGL-UK-3.0": [
        "open government licence v3.0",
    ],
    "OLDAP-2.8": [
        "the openldap public license",
        "version 2.8",
    ],
    "MulanPSL-2.0": [
        "mulan permissive software license",
        "version 2",
    ],
    "UPL-1.0": [
        "universal permissive license",
        "the universal permissive license (upl), version 1.0",
    ],
    "BlueOak-1.0.0": [
        "blue oak model license",
        "version 1.0.0",
    ],
    "SSPL-1.0": [
        "server side public license",
        "version 1, october 16, 2018",
    ],
    "BUSL-1.1": [
        "business source license 1.1",
        "change date",
        "change license",
    ],
    "Elastic-2.0": [
        "elastic license 2.0",
        "you may not provide the software to third parties as a hosted or managed service",
    ],
    # ----- small permissive notices ---------------------------------------
    "NCSA": [
        "university of illinois/ncsa open source license",
    ],
    "X11": [
        "x consortium",
        "permission is hereby granted, free of charge, to any person obtaining a copy",
    ],
    "HPND": [
        "permission to use, copy, modify and distribute this software and its documentation for any purpose and without fee is hereby granted",
    ],
    "NTP": [
        "permission to use, copy, modify, and distribute this software and its documentation for any purpose with or without fee is hereby granted, provided that the above copyright notice appears in all copies",
    ],
    "curl": [
        "copyright and permission notice",
        "permission to use, copy, modify, and distribute this software for any purpose with or without fee",
    ],
    "ICU": [
        "icu license",
        "icu 1.8.1 and later",
    ],
    "Vim": [
        "vim license",
        "vim is charityware",
    ],
    "JSON": [
        "the software shall be used for good, not evil",
    ],
    "Sleepycat": [
        "redistributions in any form must be accompanied by information on how to obtain complete source code",
    ],
    "FTL": [
        "the freetype project license",
        "portions of this software are copyright",
    ],
    "IJG": [
        "the independent jpeg group's jpeg software",
        "this software is based in part on the work of the independent jpeg group",
    ],
    "libpng-2.0": [
        "png reference library license version 2",
        "this copy of the libpng notices is provided for your convenience",
    ],
    "MIT-CMU": [
        "permission to use, copy, modify and distribute this software and its documentation is hereby granted",
        "provided that both the copyright notice and this permission notice appear",
    ],
    "Beerware": [
        "the beer-ware license",
        "you can buy me a beer in return",
    ],
    "MirOS": [
        "the miros licence",
    ],
    "Fair": [
        "usage of the works is permitted provided that this instrument is retained with the works",
    ],
    "W3C": [
        "w3c software notice and license",
    ],
    "TCL": [
        "the authors hereby grant permission to use, copy, modify, distribute, and license this software",
    ],
    "bzip2-1.0.6": [
        "this program, \"bzip2\", the associated library \"libbzip2\"",
    ],
    "OFL-1.1": [
        "sil open font license version 1.1",
    ],
    "wxWindows": [
        "wxwindows library licence",
    ],
    "ZPL-2.1": [
        "zope public license (zpl) version 2.1",
    ],
    "PHP-3.01": [
        "the php license, version 3.01",
        "this product includes php software",
    ],
    "Artistic-1.0-Perl": [
        "the \"artistic license\"",
        "the copyright holder maintains some semblance of artistic control",
    ],
    "CECILL-2.1": [
        "cecill free software license agreement",
        "version 2.1",
    ],
    "CECILL-B": [
        "cecill-b free software license agreement",
    ],
    "CECILL-C": [
        "cecill-c free software license agreement",
    ],
    "PSF-2.0": [
        "psf license agreement",
        "python software foundation",
    ],
    "Unicode-DFS-2016": [
        "unicode, inc. license agreement - data files and software",
    ],
    "Unicode-3.0": [
        "unicode license v3",
    ],
    "CC-BY-3.0": [
        "creative commons attribution 3.0",
    ],
    "CC-BY-SA-3.0": [
        "creative commons attribution-sharealike 3.0",
    ],
    "CC-BY-NC-SA-4.0": [
        "creative commons attribution-noncommercial-sharealike 4.0 international",
    ],
    "CC-BY-ND-4.0": [
        "creative commons attribution-noderivatives 4.0 international",
    ],
    "CC-BY-2.5": [
        "creative commons attribution 2.5",
    ],
    "CC-BY-SA-2.5": [
        "creative commons attribution-sharealike 2.5",
    ],
    "EUPL-1.0": [
        "european union public licence v. 1.0",
    ],
    "Artistic-1.0": [
        "the artistic license",
        "preamble",
        "the intent of this document is to state the conditions under which a package may be copied",
    ],
    "Zend-2.0": [
        "the zend engine license, version 2.00",
    ],
    "Xnet": [
        "x.net, inc. license",
    ],
    "Naumen": [
        "naumen public license",
    ],
    "Motosoto": [
        "motosoto open source license",
    ],
    "AFL-2.1": [
        "academic free license version 2.1",
    ],
    "OSL-2.1": [
        "open software license v. 2.1",
    ],
    "APL-1.0": [
        "adaptive public license",
    ],
    "Frameworx-1.0": [
        "frameworx open license",
    ],
    "NOSL": [
        "netizen open source license",
    ],
    "gnuplot": [
        "permission to use, copy, and distribute this software and its documentation for any purpose with or without fee is hereby granted",
        "permission to modify the software is granted, but not the right to distribute the complete modified source code",
    ],
}

# when both fully match, the more specific license suppresses the subsumed
# one (a BSD-3 text contains every BSD-2 phrase)
SUBSUMES: dict[str, list[str]] = {
    "BSD-3-Clause": ["BSD-2-Clause"],
    "BSD-4-Clause": ["BSD-3-Clause", "BSD-2-Clause"],
    "GPL-3.0-only": ["GPL-2.0-only"],  # shared "gnu general public license"
    "AGPL-3.0-only": [],
    "X11": ["MIT"],  # X11 text embeds the MIT grant + notice clauses
    "MIT-0": [],
}

MIN_CONFIDENCE = 0.9


def normalize(text: str) -> str:
    """Lowercase and collapse every whitespace run to a single space — the
    same transform applied to fingerprints and scanned content so matches
    survive arbitrary line wrapping."""
    return " ".join(text.lower().split())
